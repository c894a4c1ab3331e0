#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase (what CI runs)
    python3 chip_smoke.py --only build,check

Drives ``bio_ik_tpu_torch`` (never JAX) through its paths — the fullstep
tier (bench.py's configuration, the reference's recommended regularized
one, the JAX suite's two PR2 dual-arm rows on the wide megastep instance
and its snake-32 and humanoid rows on the high-DOF instances), the
species tier (floating and planar chains, with and without the
regularizers) and the FP32 peak calibration — and holds each hand-written
CUDA kernel against its plain torch version.  Phases, each
printing one JSON line and its seconds; any failure raises and exits
non-zero:

  build           — card name and power limit, torch/CUDA versions, nvcc
                    build of every kernel source (megastep.cu,
                    megastep_wide.cu, megastep_high.cu, species.cu,
                    peak.cu, in parallel), each source's nvcc seconds,
                    their ptxas reports and, per kernel instance,
                    registers, stack and spill; the wide (17, 2, 2) and
                    high-DOF (32, 1, 1), (30, 3, 3) instances' shared
                    memory per block at every group size and resident
                    blocks at each one built (or "does not fit");
  check           — megastep vs plain version, noise-tensor mode, main-path
                    sizes (PR2, V=7, K=1, C=16, gens=8, mem_iters=8, two
                    steps, N=4096): ≥ 85 % of lanes agree, beside the plain
                    version on the CPU vs the card; every group size G
                    bitwise equal to G = 1; exact FK and fitness with no
                    selection on all 131 072 lanes (atol 1e-5); the wide
                    instance (PR2 dual arm, two PoseGoals) likewise at
                    16 384 lanes, against its floor and two wrong plain
                    versions (the instances' tips swapped, the rotation
                    weights zeroed); the high-DOF instances likewise
                    (snake: one joint's axis negated, the position term
                    dropped; humanoid: tips permuted, rotation weights
                    zeroed), every G bitwise equal to the smallest that
                    fits, exact FK and fitness on 131 072 lanes;
  rng             — in-kernel Philox vs the plain version's at each main-path
                    launch's lane count (≥ 85 %), clt4 moments, rate bins
                    (the 4-bit fields of a generation's rate call), bitwise
                    repeat, salt locality;
  sec_check       — the secondary-goal megastep (the regularizers' terms,
                    and all four) at the regularized path's 131 072 lanes in
                    both RNG modes (≥ 85 %, beside the CPU-vs-card floor);
                    the species kernel with the same terms, bitwise; the
                    wide instance with the multigoal path's PoseGoal +
                    LookAtGoal and regularizers (controls: the lookat axis
                    negated, the tips swapped); the high-DOF instances
                    with all four terms (snake) and the regularizers
                    (humanoid);
  fullstep_check  — the fullstep kernel vs make_fullstep_inner at 131 072
                    lanes in both RNG modes (≥ 85 %), its time and bound;
                    the wide fullstep once per non-pose goal kind beside a
                    PoseGoal, each against its floor; the high-DOF
                    fullsteps (the humanoid also once per non-pose kind
                    on the head, and every kind's exact fitness);
  main            — bench.py's configuration through AdaptiveBatchSolver at
                    B = 65 536: success, median position error, solves/s,
                    launches per solve_batch (4), determinism, the flags
                    re-derived from the returned q, a small card/CPU solve;
  dual_main       — the JAX suite's pr2_dual_pose2 (two PoseGoals at 1 mm,
                    tools/bench_suite.py:125-132) at B = 16 384: success,
                    median position error of the worse tip, batch time,
                    launches per solve_batch (4), the profiled idle share;
  multigoal_main  — the JAX suite's pr2_dual_multigoal (PoseGoal +
                    LookAtGoal + MinimalDisplacement + AvoidJointLimits at
                    1 cm, tools/bench_suite.py:216-227) at B = 65 536: the
                    same fields, the lookat error beside a solve with the
                    LookAtGoal at weight 0, the secondary fitness beside a
                    solve without the regularizers;
  snake_main      — the JAX suite's snake32_position (PositionGoal at 5 mm,
                    tools/bench_suite.py:134-142) through a plain
                    IKSolver at B = 65 536 (524 288 lanes, 4 launches of
                    4 steps): the main fields; then with the two
                    regularizers at B = 4 096 on the secondary-goal
                    instance, its secondary fitness beside a pose-only
                    solve;
  humanoid_main   — the JAX suite's humanoid_whole_body (three PoseGoals at
                    1 cm, :175-184) at B = 16 384 with the profiled idle
                    share, and humanoid_whole_body_mm (1 mm, six phases,
                    :188-197) at B = 4 096: the main fields; then the 1 cm
                    problem with the regularizers at B = 4 096;
  regularized_main — PoseGoal + MinimalDisplacementGoal(0.05) +
                    AvoidJointLimitsGoal(0.05) on bench_suite's ladder at
                    B = 65 536: the same fields, the median secondary fitness
                    beside a pose-only solve of the same targets, and
                    IKSolver.for_tips building the same problem;
  species_check   — species kernel vs plain version in both randomness
                    modes (noise tensors; in-kernel Philox against
                    make_species_inner on philox_draw's tensors): free_arm
                    at 524 288 lanes, planar_arm at 131 072, the
                    secondary-goal instance at 131 072, bitwise under CLT4;
                    Box–Muller by lane agreement beside its CPU-vs-card
                    floor; by stage, and the noise-tensor floor;
  species_main    — the JAX suite's free_arm_floating_base row at B = 65 536,
                    then planar_arm at B = 16 384: the main fields (16
                    launches), unit quaternions, peak memory;
  species_sec_main — free_arm with the two regularizers at B = 16 384;
  times           — every kernel instance at its paths' launch shapes (CUDA
                    events; the megastep at the 8 ladder launches with the
                    G chosen and every G; the species kernel in both modes
                    with registers, spill and resident blocks) beside its
                    plain version, its FLOP/byte bound and the bound of the
                    generator's integer work (its Philox calls, one call's
                    SASS counted, at the card's IMAD, ALU and issue rates);
                    the wide instance at both dual paths' launch shapes,
                    the high-DOF ones at snake_main's and humanoid_main's
                    (every G that fits at each shape);
  profile         — torch.profiler over one solve_batch of each path: device
                    time by kernel, device busy and idle share; no torch
                    random-number kernel on the species paths;
  mfu             — ``python -m bio_ik_tpu_torch.tools.bench_mfu``'s
                    measurements; the peak kernel bitwise vs its plain
                    version at T = 64, its bound from 3 unfused FP32
                    instructions per iteration (held against the SASS of
                    its loop).

The last lines are the kernels JSON line, the ``nvidia-smi`` name/power
line, and ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when there is no CUDA device or the package is missing.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TIP = "r_gripper_tool_frame"
PHASES = ((1, 24), (2, 32), (4, 64), (8, 32))
FRACTIONS = (0.15, 0.03, 0.008)
B_MAIN = 65536
QUEUE, REPEATS = 16, 3      # bench.py: 16 batches queued, best of 3
# species tier: (urdf, batch, quaternion gene slices); tip "tool"
SPECIES_PATHS = (("free_arm.urdf", 65536, (3,)), ("planar_arm.urdf", 16384, ()))
SPECIES_QUEUE = 4
SPECIES_ISLANDS = 4
# H100 SXM published peaks (NVIDIA's data sheet, 700 W): FP32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# thread-instructions per SM and clock on sm_90 (CUDA C Programming Guide,
# arithmetic instruction throughput; four schedulers of one warp each):
# 32-bit integer multiply-add (IMAD, the FMA pipe), the other 32-bit
# integer work (add, logic, shift, compare: the ALU pipe, beside it), and
# the issue limit over all pipes
IMAD_PER_SM_CLK = 64
ALU_PER_SM_CLK = 64
ISSUE_PER_SM_CLK = 128
# FP32 instructions per SM and clock (4 × 32 lanes): an unfused multiply or
# add is one FLOP, so kernels built without FMA (species, peak) reach at
# most half the FMA-counted PEAK_FP32
FP32_PER_SM_CLK = 128
SOURCES = ("megastep", "megastep_wide", "megastep_high", "species", "peak")
# the reference's recommended configuration (tools/bench_suite.py:198-210):
# PoseGoal + MinimalDisplacementGoal(0.05) + AvoidJointLimitsGoal(0.05)
REG_PHASES = ((1, 32), (2, 64), (4, 128), (8, 256))
REG_FRACTIONS = (0.3, 0.1, 0.03)
REG_WEIGHT = 0.05
REG_QUEUE = 4
REG_TERMS = ("beta", "gamma")
ALL_TERMS = ("alpha", "beta", "gamma", "delta")
# the species tier with the same regularizers: free_arm at this batch
B_SPECIES_SEC = 16384
# the JAX suite's PR2 dual-arm rows on the wide megastep instance
# (V, K, T) = (17, 2, 2): pr2_dual_pose2 (tools/bench_suite.py:125-132) and
# pr2_dual_multigoal (:216-227)
DUAL_URDF = "pr2_dual.urdf"
DUAL_TIPS = ("r_gripper_tool_frame", "l_gripper_tool_frame")
DUAL_PHASES = ((1, 64), (2, 64), (4, 128), (8, 128))
DUAL_FRACTIONS = (0.25, 0.08, 0.03)
B_DUAL = 16384
MG_PHASES = ((1, 32), (2, 32), (4, 64), (8, 128))
MG_FRACTIONS = (0.3, 0.1, 0.04)
B_MG = 65536
DUAL_QUEUE = 4
MG_WEIGHT = 0.2
LOOKAT = dict(axis=(1.0, 0.0, 0.0), target=(1.0, 0.0, 0.5), weight=0.5)
POSE2_KINDS = ("pose", "pose")
MG_KINDS = ("pose", "lookat")
# lanes of the wide instance's checks against its plain version, and of
# the plain version on the CPU for their floor
N_WIDE_CHECK = 16384
N_WIDE_FLOOR = 4096
# a wrong plain version agrees with the kernel on fewer lanes than this
CONTROL_LIMIT = 0.5
# the wrong kind of each goal kind's control: one that reads the same rows
KIND_CONTROL = {"lookat": "line", "line": "plane", "plane": "line",
                "max_distance": "min_distance", "min_distance": "max_distance",
                "cone": "direction", "direction": "side", "side": "direction"}
# the wide exact-fitness checks' parents: this much noise (rad) about q*,
# so the relu kinds' terms act on some lanes and not on others, and every
# kind at weight 1 (checks.megastep_inputs' miss in metres and radians
# alike)
FK_SPREAD = 0.3
FK_MISS = (0.002, 0.002)
# the JAX suite's high-DOF rows on the high-DOF megastep instances
# (csrc/megastep_high.cu; robots, tips and goal kinds in
# kernels/checks.HIGH_DOF): snake32_position (tools/bench_suite.py:134-142,
# PositionGoal at 5 mm, max_steps 16) through a plain IKSolver — 4 launches
# of 4 steps on B · 4 islands · 2 species lanes — and humanoid_whole_body
# (:175-184, three PoseGoals at 1 cm, AdaptiveBatchSolver's default
# fractions) and humanoid_whole_body_mm (:188-197, at 1 mm)
B_SNAKE = 65536
SNAKE_QUEUE = 4
SNAKE_STEPS, SNAKE_CHECK = 16, 4
HB_PHASES = ((1, 32), (2, 64), (4, 128), (8, 128))
HB_FRACTIONS = (0.75, 0.25, 0.125)
B_HB = 16384
HB_QUEUE = 2
MM_PHASES = ((1, 32), (2, 64), (4, 128), (8, 256), (8, 256), (8, 256))
MM_FRACTIONS = (0.75, 0.3, 0.2, 0.15, 0.12)
B_MM = 4096
MM_QUEUE = 1
# scenarios of each high-DOF row's regularized solve (+ MinimalDisplacement
# and AvoidJointLimits at REG_WEIGHT): the path of its secondary-goal
# instance
B_HIGH_SEC = 4096
# lanes of the high-DOF instances' exact FK and fitness checks
N_HIGH_FK = 131072


KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by")
# the TPU kernels the megastep and fullstep entries replace (their
# pl.pallas_call)
MEGASTEP_TPU = "bio_ik_tpu/kernels/bio2_megastep.py:321"
FULLSTEP_TPU = "bio_ik_tpu/kernels/bio2_fullstep.py:692"


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def phase_shapes(phases=PHASES, fractions=FRACTIONS, B=B_MAIN):
    """(lanes, n_steps) of a ladder's four megastep launches: B scenarios ×
    islands × 2 species, B cut to int(B·fraction) in each retry phase."""
    out = []
    for i, (islands, steps) in enumerate(phases):
        b = B if i == 0 else max(1, int(B * fractions[i - 1]))
        out.append((b * islands * 2, steps))
    return out


def queued_ms(s, keys, data, queue):
    """Best of ``REPEATS`` × ``queue`` queued ``s.solve_batch`` calls with
    fresh keys (bench.py's timing): the per-batch times in ms."""
    import torch
    from bio_ik_tpu_torch.engine import fold_in

    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for r in range(queue):
            s.solve_batch(fold_in(keys, 1000 + r), data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / queue * 1e3)
    return times


def philox_sass_count():
    """Instructions of one Philox4x32-10 call in the megastep library's SASS:
    ``philox_probe_kernel`` less ``philox_probe_base_kernel`` (the same
    loads and stores without the call), all and the IMAD-pipe ones."""
    from bio_ik_tpu_torch.kernels.build import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build("megastep")], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name and "philox_probe" in name and not m.group(1).startswith("NOP"):
            c = counts.setdefault(name, {"all": 0, "imad": 0})
            c["all"] += 1
            c["imad"] += m.group(1).startswith("IMAD")
    probe = [v for k, v in counts.items() if "probe_kernel" in k and "base" not in k]
    base = [v for k, v in counts.items() if "base" in k]
    if not (probe and base):
        raise AssertionError(f"no Philox probe kernels in the SASS: {list(counts)}")
    return {"instructions": probe[0]["all"] - base[0]["all"],
            "imad": probe[0]["imad"] - base[0]["imad"]}


def peak_sass_loops():
    """The FP32 instructions in each loop of the peak kernel's SASS (the
    instructions from a backward branch's target to the branch): FMUL,
    FADD and FFMA counts per loop, innermost first."""
    from bio_ik_tpu_torch.kernels.build import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build("peak")], capture_output=True,
                          text=True, timeout=300).stdout
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                     line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) < addr:
            body = [o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr]
            loops.append({k: sum(o.startswith(k) for o in body)
                          for k in ("FMUL", "FADD", "FFMA")})
    return sorted(loops, key=lambda x: sum(x.values()))


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def bitwise_frac(a, b, N):
    """Share of the N lanes on which two output tuples are bitwise equal."""
    import torch

    return float(torch.stack([(x == y).reshape(-1, N).all(0) | (
        x.isnan() & y.isnan()).reshape(-1, N).all(0) for x, y in zip(a, b)])
        .all(0).float().mean())


def agree_frac(a, b):
    """Share of lanes on which two output tuples agree (checks.lane_agreement)."""
    from bio_ik_tpu_torch.kernels.checks import lane_agreement

    return float(lane_agreement(a, b).float().mean())


def cuda_ms(fn, reps):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Smoke:
    def __init__(self):
        import torch
        from bio_ik_tpu_torch import RobotModel, asset_path
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        self.torch = torch
        self.dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
        self.cpu_model = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"),
                                                   device="cpu")
        self.sp_models = {u: RobotModel.from_urdf_file(asset_path(u))
                          for u, _, _ in SPECIES_PATHS}
        self.sp_cpu_models = {u: RobotModel.from_urdf_file(asset_path(u),
                                                           device="cpu")
                              for u, _, _ in SPECIES_PATHS}
        self.dual = RobotModel.from_urdf_file(asset_path(DUAL_URDF))
        self.dual_cpu = RobotModel.from_urdf_file(asset_path(DUAL_URDF), device="cpu")
        # the wide and high-DOF instances' robots: card model, CPU model, tips
        self.robots = {"dual": (self.dual, self.dual_cpu, DUAL_TIPS)}
        for name, (urdf, tips, _, _) in HIGH_DOF.items():
            self.robots[name] = (RobotModel.from_urdf_file(asset_path(urdf)),
                                 RobotModel.from_urdf_file(asset_path(urdf), device="cpu"),
                                 tips)
        self.kernels = {name: {} for name in (
            "megastep", "megastep_dual", "megastep_dual_sec", "megastep_snake",
            "megastep_snake_sec", "megastep_humanoid", "megastep_humanoid_sec", "species",
            "fullstep", "fullstep_dual", "fullstep_snake", "fullstep_humanoid", "peak")}

    # -------------------------------------------------------------- 1 --
    def build(self):
        import torch
        from bio_ik_tpu_torch.kernels.build import (BUILD_SECONDS, build_all,
                                                    ptxas_report, ptxas_table)
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        secs = build_all(list(SOURCES))
        emit({"phase": "build", "gpu": smi_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": secs,
              "nvcc_s_by_source": dict(BUILD_SECONDS),
              "ptxas": {n: ptxas_report(n).strip().splitlines()
                        for n in SOURCES}})
        for n in SOURCES:
            for row in ptxas_table(n):
                emit({"phase": "build", "source": n, **row})
        # the wide and high-DOF instances: shared memory per block at every
        # G (those the source does not build too) and resident blocks at
        # the G it builds (0: the block does not fit)
        for robot, kinds, terms in [("dual", POSE2_KINDS, ()), ("dual", MG_KINDS, REG_TERMS)] + [
                (robot, kinds, t) for robot, (_, _, kinds, terms) in HIGH_DOF.items()
                for t in ((), terms)]:
            mega, sp = self._wide(1, kinds, terms, robot=robot)
            lib = mega._lib(2)
            resident = {g: mega.resident_blocks(lib, self.dev, g) for g in mega.groups}
            emit({"phase": "build", "robot": robot,
                  "instance": [sp.V, sp.K, len(self.robots[robot][2])], "inst_kind": kinds,
                  "sec_terms": terms, "source": mega.source,
                  "dependency_columns": mega.ncol,
                  "smem_bytes_by_group": {g: mega.smem_bytes(lib, g) for g in (1, 2, 4, 8)},
                  "resident_blocks_by_group": {g: r or "does not fit"
                                               for g, r in resident.items()},
                  "groups_not_built": [g for g in (1, 2, 4, 8) if g not in mega.groups]})
        self.philox_sass = philox_sass_count()
        emit({"phase": "build", "philox_call_sass": self.philox_sass})

    def _mega(self, n_steps, gens=8, mem_iters=8, memetic="q", sec_terms=(),
              model=None):
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams

        sp = SpeciesParams(V=7, K=1, C=16, gens=gens, mem_iters=mem_iters,
                           memetic=memetic)
        return Megastep(model or self.model, [TIP], list(range(7)), [0], sp,
                        n_steps, sec_terms=sec_terms), sp

    def _inputs(self, sp, n_steps, N, seed=7, spread=1e-3, with_noise=True,
                sec_terms=(), dev=None):
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels.checks import megastep_inputs

        dev = dev or self.dev
        state, consts, noise = megastep_inputs(
            self.model, TIP, sp, n_steps, N, seed, spread=spread,
            with_noise=with_noise, sec_terms=sec_terms)
        return (tree_from_numpy(state, dev), tree_from_numpy(consts, dev),
                None if noise is None else tree_from_numpy(noise, dev))

    def _wide(self, n_steps, kinds, terms=(), gens=8, mem_iters=8, memetic="q",
              model=None, inst_tip=None, robot="dual"):
        """The megastep of a wide or high-DOF instance on ``robot``'s tips
        (:attr:`robots`), goal instance k of ``kinds`` on tip
        ``inst_tip[k]`` (default k), every variable active."""
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams

        card, _, tips = self.robots[robot]
        model = model or card
        V, K = model.nvars, len(kinds)
        sp = SpeciesParams(V=V, K=K, C=16, gens=gens, mem_iters=mem_iters,
                           memetic=memetic)
        return Megastep(model, list(tips), list(range(V)),
                        list(range(K) if inst_tip is None else inst_tip), sp, n_steps,
                        sec_terms=terms, inst_kind=list(kinds)), sp

    def _wide_inputs(self, sp, n_steps, N, kinds, terms=(), with_noise=True, seed=7,
                     robot="dual"):
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels.checks import megastep_inputs

        _, cpu, tips = self.robots[robot]
        state, consts, noise = megastep_inputs(
            cpu, list(tips), sp, n_steps, N, seed, inst_kind=list(kinds),
            sec_terms=terms, with_noise=with_noise)
        return (tree_from_numpy(state, self.dev), tree_from_numpy(consts, self.dev),
                None if noise is None else tree_from_numpy(noise, self.dev))

    def _fitting_groups(self, mega, N):
        """The group sizes of ``mega``'s source whose block fits on the card."""
        lib = mega._lib(N)
        return [g for g in mega.groups if mega.resident_blocks(lib, self.dev, g) > 0]

    def _wide_check(self, kinds, terms=(), robot="dual"):
        """A wide or high-DOF megastep against its plain version (two steps,
        noise tensors, N_WIDE_CHECK lanes) at the group size chosen and,
        bitwise, every group size that fits against the smallest; in-kernel
        Philox against the plain version's; the floor (the plain version on
        the CPU against itself on the card, first N_WIDE_FLOOR lanes) and
        two controls, wrong plain versions: the instances' tips permuted
        (one tip: one joint's axis negated in the plain chain), and the
        lookat axis negated (or, where no instance is a lookat, the rotation
        weights zeroed; with none of those, the position term dropped).
        Fails below min(0.85, floor − 0.03) or when a control reaches
        CONTROL_LIMIT."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import array_draw, philox_draw
        from bio_ik_tpu_torch.kernels.checks import axis_negated

        N, n = N_WIDE_CHECK, N_WIDE_FLOOR
        mega, sp = self._wide(2, kinds, terms, robot=robot)
        state, consts, noise = self._wide_inputs(sp, 2, N, kinds, terms, robot=robot)
        keep = noise[4] if terms else None

        def kernel(group=None):
            return mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
                        wipe_g=noise[3], keep=keep, group=group)

        def plain(m, st, cs, nz, kp):
            return m.body(st, cs, array_draw(*nz[:4], sp.gens, keep=kp))

        groups = self._fitting_groups(mega, N)
        k_out = kernel()
        g0 = kernel(groups[0])
        p_out = plain(mega, state, consts, noise, keep)
        torch.cuda.synchronize()
        row = {"robot": robot, "inst_kind": kinds, "sec_terms": terms, "lanes": N,
               "group_chosen": mega.group(mega._lib(N), self.dev, N),
               "agree_frac": agree_frac(k_out, p_out), "reference_group": groups[0],
               "bitwise_vs_reference_group_frac": {g: bitwise_frac(kernel(g), g0, N)
                                                   for g in groups}}
        cut = lambda xs: tuple(x[..., :n].cpu() for x in xs)  # noqa: E731
        cpu_mega, _ = self._wide(2, kinds, terms, model=self.robots[robot][1], robot=robot)
        c_out = plain(cpu_mega, cut(state), cut(consts), cut(noise),
                      None if keep is None else keep[..., :n].cpu())
        row["plain_cpu_vs_card_agree_frac"] = agree_frac(c_out, cut(p_out))
        K = len(kinds)
        if K > 1:
            chain = "control_tips_permuted_agree_frac"
            other, _ = self._wide(2, kinds, terms, robot=robot,
                                  inst_tip=tuple(range(1, K)) + (0,))
        else:
            chain = "control_axis_negated_agree_frac"
            other, _ = self._wide(2, kinds, terms, robot=robot,
                                  model=axis_negated(self.robots[robot][0], sp.V // 2))
        wrong = list(consts)
        wrot = consts[mega.const_names.index("wrot")]
        if "lookat" in kinds:
            i = mega.const_names.index("gaux")
            wrong[i] = -wrong[i]
            label = "control_lookat_axis_negated_agree_frac"
        elif bool((wrot != 0).any()):
            i = mega.const_names.index("wrot")
            wrong[i] = torch.zeros_like(wrong[i])
            label = "control_rotation_weight_zero_agree_frac"
        else:
            i = mega.const_names.index("wpos")
            wrong[i] = torch.zeros_like(wrong[i])
            label = "control_position_term_dropped_agree_frac"
        row[chain] = agree_frac(g0, plain(other, state, consts, noise, keep))
        row[label] = agree_frac(g0, plain(mega, state, tuple(wrong), noise, keep))
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
        k1 = mega(state, consts, seed=4321, salt=salt)
        p1 = mega.body(state, consts, philox_draw(4321, salt, sp.V, sp.C, keep=bool(terms)))
        torch.cuda.synchronize()
        row["philox_agree_frac"] = agree_frac(k1, p1)
        row["agree_limit"] = min(0.85, row["plain_cpu_vs_card_agree_frac"] - 0.03)
        row["control_limit"] = CONTROL_LIMIT
        controls = [row[chain], row[label]]
        if min(row["agree_frac"], row["philox_agree_frac"]) < row["agree_limit"]:
            raise AssertionError(f"the {robot} megastep agrees with its plain version "
                                 f"below its limit: {row}")
        if len(groups) < len(mega.groups) and not terms:
            raise AssertionError(f"a pose-only {robot} group size does not fit: {row}")
        if min(row["bitwise_vs_reference_group_frac"].values()) < 1.0:
            raise AssertionError(f"a group size changes the {robot} megastep: {row}")
        if max(controls) >= CONTROL_LIMIT:
            raise AssertionError(f"a wrong plain version agrees with the {robot} "
                                 f"megastep: {row}")
        return row

    # -------------------------------------------------------------- 2 --
    def check(self):
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep, array_draw
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        N = 4096
        mega, sp = self._mega(2)
        state, consts, noise = self._inputs(sp, 2, N)
        k_out = mega(state, consts, noise=noise[0], rates=noise[1],
                     wipe_u=noise[2], wipe_g=noise[3])
        p_out = mega.body(state, consts, array_draw(*noise, sp.gens))
        self.torch.cuda.synchronize()
        agree = lane_agreement(k_out, p_out)
        frac = float(agree.float().mean())
        # the floor of that fraction between two correct versions that round
        # differently: the plain version on the CPU against itself on the card
        cpu = [tuple(t.cpu() for t in x) for x in (state, consts, noise)]
        cpu_mega = Megastep(self.cpu_model, [TIP], list(range(7)), [0], sp, 2)
        c_out = cpu_mega.body(cpu[0], cpu[1], array_draw(*cpu[2], sp.gens))
        floor = float(lane_agreement(p_out, c_out).float().mean())
        # no selection: zero generations, no memetic, one step — the
        # incumbent then holds the exact FK tips and fitness of parent 0;
        # compared on every lane of the first phase's launch
        N = phase_shapes()[0][0]
        fk_mega, fsp = self._mega(1, gens=0, mem_iters=0, memetic="")
        fstate, fconsts, fnoise = self._inputs(fsp, 1, N, seed=11)
        fk_k = fk_mega(fstate, fconsts, noise=fnoise[0], rates=fnoise[1],
                       wipe_u=fnoise[2], wipe_g=fnoise[3])
        fk_p = fk_mega.body(fstate, fconsts, array_draw(*fnoise, 0))
        err_tips = max_abs_err(fk_k[5], fk_p[5])
        err_fit = max_abs_err(fk_k[4], fk_p[4])
        # agreement by stage (steps, gens, mem_iters) and far from a
        # solution, for the record
        stages = {}
        for steps, gens, mem, spread in ((1, 8, 0, 1e-3), (1, 0, 8, 1e-3),
                                         (1, 8, 8, 1e-3), (2, 8, 8, 1e-2),
                                         (2, 8, 8, 5e-2)):
            m2, sp2 = self._mega(steps, gens=gens, mem_iters=mem,
                                 memetic="q" if mem else "")
            s2, c2, n2 = self._inputs(sp2, steps, 4096, spread=spread)
            a2 = lane_agreement(
                m2(s2, c2, noise=n2[0], rates=n2[1], wipe_u=n2[2], wipe_g=n2[3]),
                m2.body(s2, c2, array_draw(*n2, gens)))
            stages[f"{steps}x{gens}x{mem}@{spread}"] = float(a2.float().mean())
        # every group size G: the same bits as G = 1 (the draws do not
        # depend on G), and the plain version's agreement
        by_group = {}
        outs = {}
        for G in mega.groups:
            outs[G] = mega(state, consts, noise=noise[0], rates=noise[1],
                           wipe_u=noise[2], wipe_g=noise[3], group=G)
            by_group[G] = {"agree_frac": float(lane_agreement(outs[G], p_out)
                                               .float().mean()),
                           "bitwise_vs_g1_frac": bitwise_frac(outs[G], outs[1], 4096)}
        emit({"phase": "check", "lanes": 4096, "agree_frac": frac,
              "group_chosen": mega.group(mega._lib(4096), self.dev, 4096),
              "by_group": by_group,
              "plain_cpu_vs_card_agree_frac": floor, "fk_lanes": N,
              "fk_max_abs_err": err_tips, "fit_max_abs_err": err_fit,
              "agree_max_abs_err": max(max_abs_err(a, b, agree)
                                       for a, b in zip(k_out, p_out)),
              "agree_by_stage": stages})
        if min([frac] + [r["agree_frac"] for r in by_group.values()]) < 0.85:
            raise AssertionError(f"kernel agrees with the plain version on "
                                 f"{frac:.3f} of lanes (< 0.85): {by_group}")
        if min(r["bitwise_vs_g1_frac"] for r in by_group.values()) < 1.0:
            raise AssertionError(f"a group size changes the result: {by_group}")
        if not (err_tips <= 1e-5 and err_fit <= 1e-5):
            raise AssertionError(f"exact FK/fitness disagree: {err_tips}, {err_fit}")
        self.kernels["megastep"].update(agree_frac=frac,
                                        max_abs_err=max(err_tips, err_fit))
        self._wide_fk_check("megastep_dual", POSE2_KINDS)
        row = self._wide_check(POSE2_KINDS)
        emit({"phase": "check", "instance": [17, 2, 2], **row})
        self.kernels["megastep_dual"].update(
            agree_frac=row["agree_frac"], philox_agree_frac=row["philox_agree_frac"],
            floor_agree_frac=row["plain_cpu_vs_card_agree_frac"])
        self._high_checks("check", sec=False)

    def _high_checks(self, phase, sec):
        """The high-DOF instances (pose-only, or with ``sec`` their checks'
        secondary terms, kernels/checks.HIGH_DOF) against their plain
        versions: exact FK and fitness on N_HIGH_FK lanes, then
        :meth:`_wide_check`."""
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        for robot, (_, _, kinds, terms) in HIGH_DOF.items():
            terms = terms if sec else ()
            name = f"megastep_{robot}" + "_sec" * sec
            self._wide_fk_check(name, kinds, terms, robot=robot, N=N_HIGH_FK)
            row = self._wide_check(kinds, terms, robot=robot)
            emit({"phase": phase, **row})
            self.kernels[name].update(
                agree_frac=row["agree_frac"], philox_agree_frac=row["philox_agree_frac"],
                floor_agree_frac=row["plain_cpu_vs_card_agree_frac"],
                group=row["group_chosen"])

    def _wide_fk_check(self, name, kinds, terms=(), robot="dual", N=None):
        """No selection (zero generations, no memetic, one step) on ``N``
        lanes (default: every lane of the multigoal path's first launch):
        the incumbent then holds the exact FK tips and the exact fitness of
        every goal instance at parent 0 — the kernel's max_abs_err against
        the plain version (atol 1e-5)."""
        from bio_ik_tpu_torch.kernels.bio2_megastep import array_draw
        from bio_ik_tpu_torch.kernels.checks import max_abs_err

        N = N or phase_shapes(MG_PHASES, MG_FRACTIONS, B_MG)[0][0]
        mega, sp = self._wide(1, kinds, terms, gens=0, mem_iters=0, memetic="",
                              robot=robot)
        state, consts, noise = self._wide_inputs(sp, 1, N, kinds, terms, seed=11,
                                                 robot=robot)
        keep = noise[4] if terms else None
        k = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
                 wipe_g=noise[3], keep=keep)
        p = mega.body(state, consts, array_draw(*noise[:4], 0, keep=keep))
        err = max(max_abs_err(k[5], p[5]), max_abs_err(k[4], p[4]))
        emit({"phase": "check", "instance": [sp.V, sp.K, len(self.robots[robot][2])],
              "robot": robot, "inst_kind": kinds, "sec_terms": terms,
              "fk_lanes": N, "fk_fit_max_abs_err": err})
        self.kernels[name]["max_abs_err"] = err
        if not err <= 1e-5:
            raise AssertionError(f"wide exact FK/fitness disagree: {err}")

    # -------------------------------------------------------------- 3 --
    def rng(self):
        import torch
        from bio_ik_tpu_torch.kernels.bio2_fullstep import (
            clt4_from_fields, packed_fields, philox_words, rate_from_bits,
            rates_from_words)
        from bio_ik_tpu_torch.kernels.bio2_megastep import philox_draw
        from bio_ik_tpu_torch.kernels.checks import lane_agreement

        mega, sp = self._mega(2)
        seed = 1234567
        gen = torch.Generator(self.dev).manual_seed(3)

        def pair_salt(n):
            """One random salt per scenario; a species pair shares it."""
            s = torch.randint(-2**31, 2**31 - 1, (1, n // 2), dtype=torch.int32,
                              device=self.dev, generator=gen)
            return s.repeat_interleave(2, dim=1)

        # in-kernel Philox against the plain version's Philox, at the lane
        # count of each of the main path's launches (two steps each)
        agree = {}
        for N, _ in phase_shapes():
            state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
            salt = pair_salt(N)
            k1 = mega(state, consts, seed=seed, salt=salt)
            p1 = mega.body(state, consts, philox_draw(seed, salt, sp.V, sp.C))
            torch.cuda.synchronize()
            agree[N] = float(lane_agreement(k1, p1).float().mean())
        N = 4096
        state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
        salt = pair_salt(N)
        k1 = mega(state, consts, seed=seed, salt=salt)
        k2 = mega(state, consts, seed=seed, salt=salt)
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        groups_bitwise = {G: bitwise_frac(mega(state, consts, seed=seed, salt=salt,
                                               group=G), k1, N) for G in mega.groups}
        # one scenario's salt changes (its two lanes of one island)
        salt2 = salt.clone()
        salt2[0, 100:102] ^= 0x5A5A5A5A
        k3 = mega(state, consts, seed=seed, salt=salt2)
        changed = torch.zeros(N, dtype=torch.bool, device=self.dev)
        for a, b in zip(k1, k3):
            changed |= (a != b).any(dim=0)
        only_own = bool(changed[100:102].all()) and int(changed.sum()) == 2
        # the floor of the agreement in Philox mode: the plain version on
        # the CPU against itself on the card, the same lanes and bits
        cpu_mega, _ = self._mega(2, model=self.cpu_model)
        p_card = mega.body(state, consts, philox_draw(seed, salt, sp.V, sp.C))
        p_cpu = cpu_mega.body(tuple(t.cpu() for t in state),
                              tuple(t.cpu() for t in consts),
                              philox_draw(seed, salt.cpu(), sp.V, sp.C))
        floor = float(lane_agreement(p_card, p_cpu).float().mean())
        # the stream's statistics (the kernel draws these same bits)
        lane = torch.arange(N, device=self.dev, dtype=torch.int64)[None]
        idx = torch.arange(256, device=self.dev, dtype=torch.int64)[:, None]
        s64 = salt.to(torch.int64) & 0xFFFFFFFF
        w = philox_words(seed, lane, 0, 0, idx, s64)
        seq = torch.stack(w, 1).reshape(-1, N).unbind(0)     # 1 024 words per lane
        f = packed_fields(seq, 4 * (len(seq) * 32 // 96))
        g = torch.cat([clt4_from_fields(f[4 * v:4 * v + 4]) for v in range(len(f) // 4)]).double()
        # the 16 rate fields of each call (words x, y), as a generation's
        # rate call gives them
        fields = torch.stack([rate_from_bits(x >> (4 * k)) for x in w[:2]
                              for k in range(8)])
        same = torch.equal(fields[:, 0], rates_from_words([x[:1] for x in w], 16))
        kb = (fields.log2() + 23).round().long()
        hist = torch.bincount(kb.flatten(), minlength=16).double()
        rel = (hist / hist.mean() - 1).abs().max().item()
        out = {"phase": "rng", "kernel_vs_plain_agree_frac_by_lanes": agree,
               "plain_cpu_vs_card_agree_frac": floor,
               "bitwise_repeat": bitwise, "salt_changes_only_own_lanes": only_own,
               "group_bitwise_vs_chosen_frac": groups_bitwise,
               "gauss_draws": g.numel(), "gauss_mean": g.mean().item(),
               "gauss_var": g.var().item(), "rate_draws": kb.numel(),
               "rate_bins_max_rel_dev": rel, "rate_fields_as_plain": same}
        emit(out)
        if not (min(agree.values()) >= 0.85 and bitwise and only_own and same
                and min(groups_bitwise.values()) == 1.0
                and g.numel() >= 1 << 20
                and abs(out["gauss_mean"]) < 0.01
                and abs(out["gauss_var"] - 1) < 0.02 and rel < 0.1):
            raise AssertionError(f"RNG check failed: {out}")

    # -------------------------------------------------------------- 4 --
    def _bench(self, model, B, phases=PHASES, fractions=FRACTIONS,
               regularized=False):
        """bench.py's configuration (or, ``regularized``, the reference's
        recommended one: + MinimalDisplacementGoal + AvoidJointLimitsGoal,
        tools/bench_suite.py:202-210) through AdaptiveBatchSolver: targets
        from FK of numpy.random.default_rng(0) uniform draws in the bounds,
        seeded at neutral_q()."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import AdaptiveBatchSolver, SolverConfig, make_fk
        from bio_ik_tpu_torch.interop import tree_map

        dev = model.device
        fk = make_fk(model, [TIP])
        b = model._np_bounds
        qg = np.random.default_rng(0).uniform(
            b["min"], b["max"], size=(B, model.nvars)).astype(np.float32)
        tg = fk(torch.as_tensor(qg, device=dev))
        goals = [G.PoseGoal(link=TIP)]
        if regularized:
            goals += [G.MinimalDisplacementGoal(weight=REG_WEIGHT),
                      G.AvoidJointLimitsGoal(weight=REG_WEIGHT)]
        s = AdaptiveBatchSolver(model, goals,
                                SolverConfig(mode="bio2_memetic", dtwist=1e-3),
                                phases=phases, fractions=fractions)
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(model.neutral_q())))
        data["primary"][0]["position"] = tg.pos.contiguous()
        data["primary"][0]["orientation"] = tg.quat.contiguous()
        keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                            torch.arange(B, dtype=torch.int64)], -1).to(dev)
        return s, data, keys, fk, tg

    def _drive(self, s, data, keys, fk, tg, queue, nlaunch, slots=(0,)):
        """One path through ``s.solve_batch``: warm-up, launches of one call
        (counts set to 0 just before it), determinism, best of 3 × ``queue``
        queued batches, success, median position error (the worst of the
        position-goal tips ``slots``) and the success flags re-derived from
        the returned q."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep

        B = keys.shape[0]
        t0 = time.perf_counter()
        res = s.solve_batch(keys, data)          # warm-up (build, caches)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        Megastep.launches = 0
        res = s.solve_batch(keys, data)
        torch.cuda.synchronize()
        launches = Megastep.launches
        res2 = s.solve_batch(keys, data)
        det = all(torch.equal(a, b) for a, b in zip(res, res2))
        times = queued_ms(s, keys, data, queue)
        dt = min(times) / 1e3
        success = float(res.success.float().mean())
        sl = list(slots)
        perr = (fk(res.q).pos[:, sl] - tg.pos[:, sl]).norm(dim=-1).amax(-1)
        med = float(perr.median())
        # the returned success flags re-derived from the returned q alone:
        # exact FK, then the acceptance test (problem.cpp:259-341)
        p = s.problem
        qa = res.q[:, torch.as_tensor(p.active_vars, device=res.q.device)]
        recheck = p.check_solution(fk(res.q), qa, data)
        flags_agree = float((recheck == res.success).float().mean())
        out = {"batch": B, "success_rate": success, "median_pos_err_m": med,
               "solves_per_s": B * success / dt, "batch_time_ms": dt * 1e3,
               "times_ms": times, "first_call_s": first_s,
               "launches_per_solve_batch": launches, "deterministic": det,
               "success_flags_recheck_agree": flags_agree}
        if launches != nlaunch:
            raise AssertionError(f"{launches} megastep launches per solve_batch")
        if not det:
            raise AssertionError("two runs with the same keys differ")
        if flags_agree < 0.999:
            raise AssertionError(f"success flags disagree with a re-check: {out}")
        if not np.isfinite(med):
            raise AssertionError(f"non-finite position error: {out}")
        return res, qa, out

    def main(self):
        s, data, keys, fk, tg = self._bench(self.model, B_MAIN)
        _, _, out = self._drive(s, data, keys, fk, tg, QUEUE, len(PHASES))
        # a small solve on the card and on the CPU plain path (same keys,
        # same Philox bits): statistically alike, not lane-identical —
        # trajectories far from a solution part ways on rounding
        Bs = 256
        sg, dg, kg, _, _ = self._bench(self.model, Bs, ((1, 12), (2, 12)), (0.5,))
        sc, dc, kc, _, _ = self._bench(self.cpu_model, Bs, ((1, 12), (2, 12)), (0.5,))
        rg, rc = sg.solve_batch(kg, dg), sc.solve_batch(kc, dc)
        out = {"phase": "main", **out,
               "small_solve_success_gpu_cpu": [float(rg.success.float().mean()),
                                               float(rc.success.float().mean())]}
        emit(out)
        self.kernels["megastep"]["launches"] = out["launches_per_solve_batch"]
        if not (out["success_rate"] >= 0.999 and out["median_pos_err_m"] <= 1.7e-6):
            raise AssertionError(f"quality below the JAX path's: {out}")

    def _dual_bench(self, B, goals, cfg, phases, fractions, robot="dual"):
        """A row of the JAX suite on ``robot`` (the PR2 dual arm, the snake,
        the humanoid) through AdaptiveBatchSolver, or with ``phases`` None
        a plain IKSolver (tools/bench_suite.py run_config): targets from FK
        of numpy.random.default_rng(0) uniform draws in the bounds, each
        position/pose goal given its tip's, seeded at neutral_q().  Returns
        the fields of :meth:`_bench` and the position-goal tips' slots."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch import AdaptiveBatchSolver, IKSolver, make_fk
        from bio_ik_tpu_torch.interop import tree_map

        model = self.robots[robot][0]
        s = (IKSolver(model, goals, cfg) if phases is None else
             AdaptiveBatchSolver(model, goals, cfg, phases=phases, fractions=fractions))
        p = s.problem
        fk = make_fk(model, p.tip_links)
        b = model._np_bounds
        qg = np.random.default_rng(0).uniform(
            b["min"], b["max"], size=(B, model.nvars)).astype(np.float32)
        tg = fk(torch.as_tensor(qg, device=model.device))
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(model.neutral_q())))
        slots = set()
        for grp, gd in zip(p.primary, data["primary"]):
            if grp.goal_type not in ("position", "pose"):
                continue
            for k, slot in enumerate(grp.tip_slots.tolist()):
                slots.add(slot)
                gd["position"][:, k] = tg.pos[:, slot]
                if "orientation" in gd:
                    gd["orientation"][:, k] = tg.quat[:, slot]
        keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                            torch.arange(B, dtype=torch.int64)], -1).to(model.device)
        return s, data, keys, fk, tg, tuple(sorted(slots))

    def dual_main(self):
        """The JAX suite's pr2_dual_pose2: a PoseGoal on each gripper at
        1 mm (dtwist = 1e-3), its ladder, B = 16 384, on the wide pose-only
        megastep."""
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import SolverConfig

        s, data, keys, fk, tg, slots = self._dual_bench(
            B_DUAL, [G.PoseGoal(link=t) for t in DUAL_TIPS],
            SolverConfig(mode="bio2_memetic", dtwist=1e-3), DUAL_PHASES, DUAL_FRACTIONS)
        eng = s.solvers[0].engine
        assert eng.mega.source == "megastep_wide" and not eng.sec_terms, eng.sec_terms
        _, _, out = self._drive(s, data, keys, fk, tg, DUAL_QUEUE, len(DUAL_PHASES), slots)
        prof = self._profile(s, data, keys)
        out = {"phase": "dual_main", **out, "device_idle_share": prof["device_idle_share"],
               "profile": prof, "gpu": smi_line()}
        emit(out)
        self.kernels["megastep_dual"]["launches"] = out["launches_per_solve_batch"]
        if not (out["success_rate"] >= 0.999 and out["median_pos_err_m"] <= 3.4e-6):
            raise AssertionError(f"pr2_dual_pose2 below its limits: {out}")

    def multigoal_main(self):
        """The JAX suite's pr2_dual_multigoal: a PoseGoal on the right
        gripper, a LookAtGoal on the left one, MinimalDisplacement and
        AvoidJointLimits (0.2 each) at 1 cm, its ladder, B = 65 536, on the
        wide secondary-goal megastep; the lookat error beside a solve of
        the same targets without the LookAtGoal, the secondary fitness
        beside one without the two regularizers."""
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import SolverConfig
        from bio_ik_tpu_torch.problem import _EVALUATORS

        pose = G.PoseGoal(link=DUAL_TIPS[0])
        look = G.LookAtGoal(link=DUAL_TIPS[1], **LOOKAT)
        regs = [G.MinimalDisplacementGoal(weight=MG_WEIGHT),
                G.AvoidJointLimitsGoal(weight=MG_WEIGHT)]
        cfg = SolverConfig(mode="bio2_memetic", dpos=1e-2, drot=float("inf"),
                           dtwist=float("inf"))

        def bench(goals):
            return self._dual_bench(B_MG, goals, cfg, MG_PHASES, MG_FRACTIONS)

        s, data, keys, fk, tg, slots = bench([pose, look] + regs)
        eng = s.solvers[0].engine
        assert (eng.mega.source == "megastep_wide" and eng.inst_kind == list(MG_KINDS)
                and eng.sec_terms == REG_TERMS), (eng.inst_kind, eng.sec_terms)
        res, qa, out = self._drive(s, data, keys, fk, tg, DUAL_QUEUE, len(MG_PHASES), slots)
        p = s.problem
        li = [grp.kind for grp in p.primary].index("lookat")

        def lookat_err(q):
            t = fk(q)
            tips = torch.cat([t.pos, t.quat], -1)
            return _EVALUATORS["lookat"](p, p.primary[li], data["primary"][li], tips,
                                         None, None)[:, 0]

        def active(q):
            return q[:, torch.as_tensor(p.active_vars, device=q.device)]

        # without the LookAtGoal: its instance kept at weight 0 (the (17, 1, 1)
        # problem of the gripper alone has no kernel instance), so it
        # neither pulls the solve nor fails the acceptance test
        s1, d1, k1, _, _, _ = bench([pose, G.LookAtGoal(link=DUAL_TIPS[1], **{
            **LOOKAT, "weight": 0.0})] + regs)
        r1 = s1.solve_batch(k1, d1)
        s2, d2, k2, _, _, _ = bench([pose, look])
        r2 = s2.solve_batch(k2, d2)
        prof = self._profile(s, data, keys)
        out = {"phase": "multigoal_main", **out,
               "median_lookat_err": float(lookat_err(res.q).median()),
               "median_lookat_err_without_lookat": float(lookat_err(r1.q).median()),
               "median_secondary_fitness": float(p.fitness_secondary(qa, data).median()),
               "median_secondary_fitness_without_regularizers": float(
                   p.fitness_secondary(active(r2.q), data).median()),
               "ablation_success_rates": [float(r1.success.float().mean()),
                                          float(r2.success.float().mean())],
               "device_idle_share": prof["device_idle_share"], "profile": prof,
               "gpu": smi_line()}
        emit(out)
        self.kernels["megastep_dual_sec"]["launches"] = out["launches_per_solve_batch"]
        if not (out["success_rate"] >= 0.999 and out["median_pos_err_m"] <= 5e-3):
            raise AssertionError(f"pr2_dual_multigoal below its limits: {out}")
        if not out["median_lookat_err"] < out["median_lookat_err_without_lookat"]:
            raise AssertionError(f"the LookAtGoal did not lower the lookat error: {out}")
        if not (out["median_secondary_fitness"]
                < out["median_secondary_fitness_without_regularizers"]):
            raise AssertionError(f"the regularizers did not lower the secondary "
                                 f"fitness: {out}")

    def _high_sec_solve(self, robot, goals, cfg, phases, fractions, nlaunch):
        """The row's problem with MinimalDisplacement and AvoidJointLimits
        (REG_WEIGHT each) at B_HIGH_SEC scenarios on the secondary-goal
        instance (:meth:`_drive`'s fields, counts set to 0 just before its
        counted solve), its secondary fitness beside that of the same
        targets solved without them."""
        import torch
        import bio_ik_tpu_torch.goals as G

        regs = [G.MinimalDisplacementGoal(weight=REG_WEIGHT),
                G.AvoidJointLimitsGoal(weight=REG_WEIGHT)]
        s, data, keys, fk, tg, slots = self._dual_bench(
            B_HIGH_SEC, goals + regs, cfg, phases, fractions, robot=robot)
        eng = (s.engine if phases is None else s.solvers[0].engine)
        assert eng.mega.source == "megastep_high" and eng.sec_terms == REG_TERMS
        lanes = keys.shape[0] * eng.islands * 2
        res, qa, out = self._drive(s, data, keys, fk, tg, 1, nlaunch, slots)
        s0, d0, k0, _, _, _ = self._dual_bench(B_HIGH_SEC, goals, cfg, phases, fractions,
                                               robot=robot)
        r0 = s0.solve_batch(k0, d0)
        p = s.problem
        qa0 = r0.q[:, torch.as_tensor(p.active_vars, device=r0.q.device)]
        out.update(group_first_launch=eng.mega.group(eng.mega._lib(lanes), self.dev, lanes),
                   median_secondary_fitness=float(p.fitness_secondary(qa, data).median()),
                   median_secondary_fitness_without_regularizers=float(
                       p.fitness_secondary(qa0, data).median()),
                   success_rate_without_regularizers=float(r0.success.float().mean()))
        self.kernels[f"megastep_{robot}_sec"]["launches"] = out["launches_per_solve_batch"]
        if not (out["median_secondary_fitness"]
                < out["median_secondary_fitness_without_regularizers"]):
            raise AssertionError(f"the regularizers did not lower the {robot}'s "
                                 f"secondary fitness: {out}")
        return out

    def snake_main(self):
        """The JAX suite's snake32_position: a PositionGoal on the snake's
        head at 5 mm (dtwist = ∞), max_steps 16 through a plain IKSolver —
        4 launches of 4 steps on B_SNAKE · 4 islands · 2 species lanes — on
        the (32, 1, 1) pose-only instance; then the same problem with the
        two regularizers at B_HIGH_SEC on its secondary-goal instance."""
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import SolverConfig

        goals = [G.PositionGoal(link="head")]
        cfg = SolverConfig(mode="bio2_memetic", dpos=5e-3, dtwist=float("inf"),
                           max_steps=SNAKE_STEPS, steps_per_check=SNAKE_CHECK)
        nlaunch = SNAKE_STEPS // SNAKE_CHECK
        s, data, keys, fk, tg, slots = self._dual_bench(B_SNAKE, goals, cfg, None, None,
                                                        robot="snake")
        eng = s.engine
        assert eng.mega.source == "megastep_high" and not eng.sec_terms, eng.sec_terms
        _, _, out = self._drive(s, data, keys, fk, tg, SNAKE_QUEUE, nlaunch, slots)
        out = {"phase": "snake_main", **out,
               "regularized": self._high_sec_solve("snake", goals, cfg, None, None, nlaunch),
               "gpu": smi_line()}
        emit(out)
        self.kernels["megastep_snake"]["launches"] = out["launches_per_solve_batch"]
        if not (out["success_rate"] >= 0.999 and out["median_pos_err_m"] <= 8.5e-7):
            raise AssertionError(f"snake32_position below its limits: {out}")

    def humanoid_main(self):
        """The JAX suite's humanoid_whole_body (PoseGoals on both hands and
        the head at 1 cm, dtwist = ∞, its ladder and AdaptiveBatchSolver's
        default fractions) at B_HB, with the profiled idle share of one
        batch, and humanoid_whole_body_mm (the same at 1 mm, its six-phase
        ladder) at B_MM, on the (30, 3, 3) pose-only instance; then the 1 cm
        problem with the two regularizers at B_HIGH_SEC on its
        secondary-goal instance."""
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import SolverConfig
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        goals = [G.PoseGoal(link=t) for t in HIGH_DOF["humanoid"][1]]
        out = {"phase": "humanoid_main"}
        for key, B, dpos, phases, fractions, queue in (
                ("humanoid_whole_body", B_HB, 1e-2, HB_PHASES, HB_FRACTIONS, HB_QUEUE),
                ("humanoid_whole_body_mm", B_MM, 1e-3, MM_PHASES, MM_FRACTIONS,
                 MM_QUEUE)):
            cfg = SolverConfig(mode="bio2_memetic", dpos=dpos, dtwist=float("inf"))
            s, data, keys, fk, tg, slots = self._dual_bench(B, goals, cfg, phases,
                                                            fractions, robot="humanoid")
            eng = s.solvers[0].engine
            assert eng.mega.source == "megastep_high" and not eng.sec_terms
            _, _, row = self._drive(s, data, keys, fk, tg, queue, len(phases), slots)
            if key == "humanoid_whole_body":
                prof = self._profile(s, data, keys)
                row.update(device_idle_share=prof["device_idle_share"], profile=prof)
                self.kernels["megastep_humanoid"]["launches"] = row[
                    "launches_per_solve_batch"]
            out[key] = row
            del s, data, keys
        cfg = SolverConfig(mode="bio2_memetic", dpos=1e-2, dtwist=float("inf"))
        out["regularized"] = self._high_sec_solve("humanoid", goals, cfg, HB_PHASES,
                                                  HB_FRACTIONS, len(HB_PHASES))
        out["gpu"] = smi_line()
        emit(out)
        for key, med in (("humanoid_whole_body", 1e-3), ("humanoid_whole_body_mm", 3e-5)):
            if not (out[key]["success_rate"] >= 0.995
                    and out[key]["median_pos_err_m"] <= med):
                raise AssertionError(f"{key} below its limits: {out[key]}")

    def regularized_main(self):
        """Path (a): the reference's recommended configuration (pose +
        minimal displacement + avoid joint limits, weight 0.05) at B = 65 536
        through AdaptiveBatchSolver on the SEC megastep; its secondary
        fitness beside the same targets solved pose-only; path (c),
        IKSolver.for_tips with the plugin's regularizer weights, builds the
        same problem."""
        import torch
        from bio_ik_tpu_torch import IKSolver, SolverConfig
        from bio_ik_tpu_torch.interop import tree_map

        s, data, keys, fk, tg = self._bench(self.model, B_MAIN, REG_PHASES,
                                            REG_FRACTIONS, regularized=True)
        eng = s.solvers[0].engine
        assert eng.fullstep and eng.sec_terms == REG_TERMS, eng.sec_terms
        res, qa, out = self._drive(s, data, keys, fk, tg, REG_QUEUE, len(REG_PHASES))
        p = s.problem
        fsec = float(p.fitness_secondary(qa, data).median())
        # the same targets without the regularizers, measured by the
        # regularized problem's secondary fitness
        s0, d0, k0, _, _ = self._bench(self.model, B_MAIN, REG_PHASES, REG_FRACTIONS)
        r0 = s0.solve_batch(k0, d0)
        t0_ms = queued_ms(s0, k0, d0, REG_QUEUE)
        qa0 = r0.q[:, torch.as_tensor(p.active_vars, device=r0.q.device)]
        fsec0 = float(p.fitness_secondary(qa0, data).median())
        ft = IKSolver.for_tips(self.model, [TIP], SolverConfig(
            mode="bio2_memetic", dtwist=1e-3, minimal_displacement_weight=REG_WEIGHT,
            avoid_joint_limits_weight=REG_WEIGHT, max_steps=32, steps_per_check=32))

        def rows(solver, engine):
            d = tree_map(lambda x: x[None], solver.make_data(
                torch.as_tensor(self.model.neutral_q())))
            return engine._secondary_rows(d, 1)

        same = (ft.engine.sec_terms == eng.sec_terms
                and torch.equal(rows(ft, ft.engine), rows(s, eng)))
        out = {"phase": "regularized_main", **out,
               "median_secondary_fitness": fsec,
               "median_secondary_fitness_pose_only": fsec0,
               "pose_only_success_rate": float(r0.success.float().mean()),
               "pose_only_batch_time_ms": min(t0_ms),
               "for_tips_same_problem": bool(same)}
        emit(out)
        self.kernels["megastep"]["regularized_launches"] = out["launches_per_solve_batch"]
        if not (out["success_rate"] >= 0.999 and out["median_pos_err_m"] <= 5.2e-4):
            raise AssertionError(f"regularized quality below the limits: {out}")
        if not fsec < fsec0:
            raise AssertionError(f"the regularizers did not lower the secondary "
                                 f"fitness: {fsec} vs {fsec0}")
        if not same:
            raise AssertionError("IKSolver.for_tips built another problem")

    # -------------------------------------------------------------- 5 --
    def _species_args(self, urdf, N, gens=8, mem_iters=8, memetic="q", dev=None,
                      sec_terms=(), philox=False):
        """A SpeciesKernel of the robot's species path and one step's
        arguments on ``N`` lanes (kernels/checks.species_inputs): the
        noise-tensor arguments, or with ``philox`` ``(args, kw)`` for the
        in-kernel Philox mode (``kw``: salt, sec)."""
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel, SpeciesParams
        from bio_ik_tpu_torch.kernels.checks import species_inputs

        qs = dict((u, q) for u, _, q in SPECIES_PATHS)[urdf]
        model = self.sp_cpu_models[urdf]
        sp = SpeciesParams(V=model.nvars, K=1, gens=gens, mem_iters=mem_iters,
                           memetic=memetic, quat_slices=qs)
        args = species_inputs(model, "tool", sp, N, sec_terms=sec_terms, philox=philox)
        return SpeciesKernel(sp, sec_terms), tree_from_numpy(args, dev or self.dev)

    @staticmethod
    def _species_philox_plain(kern, args, kw, seed, step, gauss_mode="clt4"):
        """The plain version of a Philox-mode species step: make_species_inner
        on the draws of bio2_megastep.philox_draw (SpeciesKernel.philox_tensors)."""
        noise, rates, keeps = kern.philox_tensors(seed, step, kw["salt"], gauss_mode)
        extra = (keeps, kw["sec"]) if kern.sec_terms else ()
        return kern.inner(*args, noise, rates, *extra)

    def species_check(self):
        """The species kernel against its plain version in both randomness
        modes: free_arm at 524 288 lanes, planar_arm at 131 072 and the
        secondary-goal instance (the regularizers' terms, free_arm) at
        131 072 — bitwise under CLT4 and with noise tensors; Box–Muller
        (logf/cosf) by lane agreement (≥ 0.999, just under the floor of the
        plain version on the CPU against itself on the card: 0.99994 on an
        H100) beside that floor; the noise-tensor
        floor and agreement by stage as before."""
        import torch
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        out = {"phase": "species_check"}
        shapes = [(urdf, B * SPECIES_ISLANDS * 2, ()) for urdf, B, _ in SPECIES_PATHS] + [
            (SPECIES_PATHS[0][0], B_SPECIES_SEC * SPECIES_ISLANDS * 2, REG_TERMS)]
        bitwise, errs = {}, []
        for urdf, N, terms in shapes:
            label = urdf.split(".")[0] + ("_regularized" if terms else "")
            row = {"lanes": N, "sec_terms": terms}
            kern, args = self._species_args(urdf, N, sec_terms=terms)
            k_out = kern(*args)
            p_out = kern.inner(*args)
            torch.cuda.synchronize()
            agree = lane_agreement(k_out, p_out)
            row.update(noise_tensor_agree_frac=float(agree.float().mean()),
                       noise_tensor_bitwise_frac=bitwise_frac(k_out, p_out, N))
            errs.append(max(max_abs_err(a, b) for a, b in zip(k_out, p_out)))
            del args, k_out, p_out
            kern, (args, kw) = self._species_args(urdf, N, sec_terms=terms, philox=True)
            k_out = kern(*args, seed=2024, step=5, **kw)
            p_out = self._species_philox_plain(kern, args, kw, 2024, 5)
            torch.cuda.synchronize()
            row["philox_bitwise_frac"] = bitwise_frac(k_out, p_out, N)
            errs.append(max(max_abs_err(a, b) for a, b in zip(k_out, p_out)))
            bitwise[label] = min(row["noise_tensor_bitwise_frac"],
                                 row["philox_bitwise_frac"])
            out[label] = row
            del args, kw, k_out, p_out
            torch.cuda.empty_cache()
        # Box–Muller: the kernel's logf/cosf against torch's, 65 536 lanes,
        # beside the plain version on the CPU against itself on the card
        urdf = SPECIES_PATHS[0][0]
        kern, (args, kw) = self._species_args(urdf, 65536, philox=True)
        k_bm = kern(*args, seed=2024, step=5, gauss_mode="box_muller", **kw)
        p_bm = self._species_philox_plain(kern, args, kw, 2024, 5, "box_muller")
        c_bm = self._species_philox_plain(kern, [a.cpu() for a in args],
                                          {k: v.cpu() for k, v in kw.items()},
                                          2024, 5, "box_muller")
        bm = {"lanes": 65536,
              "agree_frac": float(lane_agreement(k_bm, p_bm).float().mean()),
              "plain_cpu_vs_card_agree_frac": float(lane_agreement(c_bm, p_bm)
                                                    .float().mean())}
        out["box_muller"] = bm
        del args, kw, k_bm, p_bm, c_bm
        # the floor between two correct versions: the plain version on the
        # CPU against itself on the card (4 096 lanes, noise tensors)
        kern, cargs = self._species_args(urdf, 4096, dev="cpu")
        c_out = kern.inner(*cargs)
        g_out = kern.inner(*(a.to(self.dev) for a in cargs))
        out["plain_cpu_vs_card_agree_frac"] = float(
            lane_agreement(c_out, g_out).float().mean())
        # agreement by stage, kernel vs plain version, 65 536 lanes
        stages = {}
        for label, gens, mem, memetic in (("generations", 8, 0, ""),
                                          ("memetic_q", 0, 8, "q"),
                                          ("memetic_l", 0, 8, "l")):
            kern, args = self._species_args(urdf, 65536, gens, mem, memetic)
            stages[label] = float(lane_agreement(kern(*args), kern.inner(*args))
                                  .float().mean())
        out["agree_by_stage"] = stages
        emit(out)
        self.kernels["species"].update(
            agree_frac=min(bitwise.values()), bitwise_frac_by_instance=bitwise,
            box_muller_agree_frac=bm["agree_frac"], max_abs_err=max(errs))
        if min(bitwise.values()) < 1.0:
            raise AssertionError(f"the species kernel is not bitwise its plain "
                                 f"version on every lane: {bitwise}")
        if bm["agree_frac"] < 0.999:
            raise AssertionError(f"Box–Muller species kernel agrees on "
                                 f"{bm['agree_frac']:.5f} of lanes (< 0.999)")

    # -------------------------------------------------------------- 6 --
    def _species_bench(self, urdf, B, regularized=False):
        """The JAX suite's floating-base row on ``urdf`` at batch ``B``
        (with ``regularized``, plus MinimalDisplacementGoal and
        AvoidJointLimitsGoal of weight 0.05): targets from FK of
        numpy.random.default_rng(0) uniform draws in the bounds, seeded at
        neutral_q()."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, SolverConfig, make_fk
        from bio_ik_tpu_torch.interop import tree_map

        model = self.sp_models[urdf]
        dev = model.device
        fk = make_fk(model, ["tool"])
        b = model._np_bounds
        qg = np.random.default_rng(0).uniform(
            b["min"], b["max"], size=(B, model.nvars)).astype(np.float32)
        tg = fk(torch.as_tensor(qg, device=dev))
        goals = [G.PositionGoal(link="tool")]
        if regularized:
            goals += [G.MinimalDisplacementGoal(weight=REG_WEIGHT),
                      G.AvoidJointLimitsGoal(weight=REG_WEIGHT)]
        s = IKSolver(model, goals,
                     SolverConfig(mode="bio2_memetic", dpos=5e-3,
                                  dtwist=float("inf"), max_steps=16,
                                  islands=SPECIES_ISLANDS))
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(model.neutral_q())))
        data["primary"][0]["position"] = tg.pos.contiguous()
        keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                            torch.arange(B, dtype=torch.int64)], -1).to(dev)
        return s, data, keys, fk, tg

    def _species_drive(self, urdf, B, regularized=False):
        """One species-tier path through IKSolver.solve_batch: the fields of
        :meth:`_drive` for the species kernel, the share of unit floating
        quaternions and the peak memory."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel
        from bio_ik_tpu_torch.robot.urdf import FLOATING

        s, data, keys, fk, tg = self._species_bench(urdf, B, regularized)
        assert not s.engine.fullstep
        assert s.engine.sec_terms == (REG_TERMS if regularized else ())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = s.solve_batch(keys, data)          # warm-up
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        SpeciesKernel.launches = 0
        res = s.solve_batch(keys, data)
        torch.cuda.synchronize()
        launches = SpeciesKernel.launches
        res2 = s.solve_batch(keys, data)
        det = all(torch.equal(a, b) for a, b in zip(res, res2))
        peak = torch.cuda.max_memory_allocated()
        times = queued_ms(s, keys, data, SPECIES_QUEUE)
        dt = min(times) / 1e3
        success = float(res.success.float().mean())
        perr = (fk(res.q).pos[:, 0] - tg.pos[:, 0]).norm(dim=-1)
        med = float(perr.median())
        p = s.problem
        qa = res.q[:, torch.as_tensor(p.active_vars, device=res.q.device)]
        recheck = p.check_solution(fk(res.q), qa, data)
        flags_agree = float((recheck == res.success).float().mean())
        model = self.sp_models[urdf]
        qnorm_share = None
        for li in range(model.nlinks):
            if model.jtype[li] == FLOATING:
                vs = int(model.vstart[li])
                qn = res.q[:, vs + 3:vs + 7].norm(dim=-1)
                qnorm_share = float(((qn - 1).abs() <= 1e-2).float().mean())
        out = {"robot": urdf, "batch": B, "lanes": B * SPECIES_ISLANDS * 2,
               "success_rate": success, "median_pos_err_m": med,
               "solves_per_s": B * success / dt, "batch_time_ms": dt * 1e3,
               "times_ms": times, "first_call_s": first_s,
               "launches_per_solve_batch": launches, "deterministic": det,
               "success_flags_recheck_agree": flags_agree,
               "unit_quat_share": qnorm_share, "peak_mem_gb": peak / 1e9,
               "peak_mem_above_inputs_gb": (peak - base_mem) / 1e9}
        if regularized:
            out["median_secondary_fitness"] = float(
                p.fitness_secondary(qa, data).median())
        fail = None
        if launches != 16:
            fail = f"{launches} species launches per solve_batch"
        elif not det:
            fail = "two runs with the same keys differ"
        elif flags_agree < 0.999:
            fail = "success flags disagree with a re-check"
        elif not (success >= 0.999 and med <= 5e-4 and np.isfinite(med)):
            fail = "species-tier quality below the limits"
        del s, data, res, res2
        torch.cuda.empty_cache()
        return out, fail

    def species_main(self):
        for urdf, B, _ in SPECIES_PATHS:
            out, fail = self._species_drive(urdf, B)
            emit({"phase": "species_main", **out})
            if urdf == SPECIES_PATHS[0][0]:
                self.kernels["species"]["launches"] = out["launches_per_solve_batch"]
            if fail:
                raise AssertionError(f"{fail}: {out}")

    def species_sec_main(self):
        """Path (b): free_arm with the regularizers at B = 16 384 on the
        species kernel's secondary-goal instance; its secondary fitness
        beside the pose-only species path's solutions of the same targets."""
        import torch

        out, fail = self._species_drive(SPECIES_PATHS[0][0], B_SPECIES_SEC,
                                         regularized=True)
        # the same targets without the regularizers, measured by the
        # regularized problem's secondary fitness
        s, data, keys, _, _ = self._species_bench(SPECIES_PATHS[0][0],
                                                  B_SPECIES_SEC, True)
        s0, d0, k0, _, _ = self._species_bench(SPECIES_PATHS[0][0], B_SPECIES_SEC)
        r0 = s0.solve_batch(k0, d0)
        out["pose_only_batch_time_ms"] = min(queued_ms(s0, k0, d0, SPECIES_QUEUE))
        p = s.problem
        qa0 = r0.q[:, torch.as_tensor(p.active_vars, device=r0.q.device)]
        out["median_secondary_fitness_pose_only"] = float(
            p.fitness_secondary(qa0, data).median())
        emit({"phase": "species_sec_main", **out})
        self.kernels["species"]["regularized_launches"] = out["launches_per_solve_batch"]
        if fail:
            raise AssertionError(f"{fail}: {out}")
        if not out["median_secondary_fitness"] < out["median_secondary_fitness_pose_only"]:
            raise AssertionError(f"the regularizers did not lower the secondary "
                                 f"fitness: {out}")

    # -------------------------------------------------------------- 8 --
    @staticmethod
    def _profile(s, data, keys):
        """torch.profiler over one warm solve_batch: device time by kernel
        name and the device's busy share of the host-clock wall time."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        s.solve_batch(keys, data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve_batch(keys, data)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

        def dev_us(e):
            return getattr(e, "self_device_time_total", 0.0) or 0.0

        # device events only (the kernels): an aten op's self device time
        # repeats the time of the kernels it launched
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        busy_us = sum(dev_us(e) for e in ev)
        top = sorted(ev, key=lambda e: -dev_us(e))[:10]
        # torch's random-number kernels (torch.randint and the like)
        rng = [e for e in ev if "distribution" in e.key or "philox" in e.key.lower()]
        return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                "device_idle_share": 1.0 - busy_us / wall_us,
                "device_ops": len(ev),
                "torch_rng_kernels": sum(e.count for e in rng),
                "torch_rng_ms": sum(dev_us(e) for e in rng) / 1e3,
                "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                         "count": e.count} for e in top]}

    def profile(self):
        """Where one solve_batch of each path spends device time."""
        s, data, keys, _, _ = self._bench(self.model, B_MAIN)
        emit({"phase": "profile", "path": "main", **self._profile(s, data, keys)})
        s, data, keys, _, _ = self._bench(self.model, B_MAIN, REG_PHASES,
                                          REG_FRACTIONS, regularized=True)
        emit({"phase": "profile", "path": "regularized",
              **self._profile(s, data, keys)})
        # the species paths draw in the kernel: no torch random-number kernel
        urdf, B, _ = SPECIES_PATHS[0]
        rng = []
        for path, batch, reg in (("species", B, False),
                                 ("species_regularized", B_SPECIES_SEC, True)):
            s, data, keys, _, _ = self._species_bench(urdf, batch, reg)
            out = self._profile(s, data, keys)
            emit({"phase": "profile", "path": path, "robot": urdf, "batch": batch, **out})
            rng.append(out["torch_rng_kernels"])
            del s, data, keys
        if any(rng):
            raise AssertionError(f"torch random-number kernels on the species paths: {rng}")

    # -------------------------------------------------------------- 7 --
    def _philox_clocks(self):
        """(SM clocks of one Philox call — one call's SASS counted, at the
        larger of the IMAD pipe's, the ALU pipe's and the issue limit's
        time —, SM clocks per second of the card: SMs × max SM clock)."""
        import torch

        if not hasattr(self, "philox_sass"):
            self.philox_sass = philox_sass_count()
        sass = self.philox_sass
        clocks_per_call = max(sass["imad"] / IMAD_PER_SM_CLK,
                              (sass["instructions"] - sass["imad"]) / ALU_PER_SM_CLK,
                              sass["instructions"] / ISSUE_PER_SM_CLK)
        sm_clocks = (max_sm_clock_hz()
                     * torch.cuda.get_device_properties(self.dev).multi_processor_count)
        return clocks_per_call, sm_clocks

    def _mega_rows(self, shapes, sec_terms=()):
        """The megastep (in-kernel Philox) at each (lanes, n_steps) launch
        shape, CUDA events: at the group size G the wrapper chooses and at
        every G, beside its bounds: ``bound_ms``, the larger of FP32 (the
        TPU cost model's counts, which leave out the secondary terms) and
        bytes, and ``int_bound_ms``, the generator's integer work alone —
        its Philox calls, one call's SASS counted, at the larger of the
        IMAD pipe's, the ALU pipe's and the issue limit's time — and, with
        ``sec_terms``, the pose-only kernel at the same shape."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            megastep_flops_per_lane, philox_calls_per_lane_step)

        clocks_per_call, sm_clocks = self._philox_clocks()
        rows = []
        for N, steps in shapes:
            row = {"lanes": N, "n_steps": steps}
            salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
            for key, terms in (("ms", sec_terms),) + (
                    (("pose_only_ms", ()),) if sec_terms else ()):
                mega, sp = self._mega(steps, sec_terms=terms)
                state, consts, _ = self._inputs(sp, steps, N, with_noise=False,
                                                sec_terms=terms)
                G = mega.group(mega._lib(N), self.dev, N)
                by = {}
                for g in mega.groups if key == "ms" else (G,):
                    run = lambda: mega(state, consts, seed=99, salt=salt, group=g)  # noqa: E731
                    run()
                    torch.cuda.synchronize()
                    by[g] = cuda_ms(run, 3)
                row[key] = by[G]
                if key == "ms":
                    row.update(group=G, ms_by_group=by)
                del state, consts
            flops = megastep_flops_per_lane(sp, steps) * N
            V, K = sp.V, sp.K
            nbytes = 4 * N * (2 * (4 * V + 2 + V + 7) + 5 * V + 9 * K + 1 + 1
                              + (8 * V if sec_terms else 0))
            calls = philox_calls_per_lane_step(sp) * N * steps
            ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
            int_ms = calls * clocks_per_call / sm_clocks * 1e3
            bound = max(ops_ms, bytes_ms)
            row.update(gflop=flops / 1e9, bytes=nbytes, philox_calls=calls,
                       fp32_bound_ms=ops_ms, int_bound_ms=int_ms, bound_ms=bound,
                       bound_by="bytes" if bound == bytes_ms else "operations",
                       flop_rate_tflops=flops / row["ms"] / 1e9,
                       ns_per_lane_step=row["ms"] * 1e6 / (N * steps))
            rows.append(row)
        return rows

    def times(self):
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            megastep_flops_per_lane, philox_draw)

        shapes = phase_shapes()
        rows = self._mega_rows(shapes)
        reg_rows = self._mega_rows(phase_shapes(REG_PHASES, REG_FRACTIONS),
                                   REG_TERMS)
        # plain version at phase 1's shape (the same Philox bits), once
        N, steps = shapes[0]
        mega, sp = self._mega(steps)
        state, consts, _ = self._inputs(sp, steps, N, with_noise=False)
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
        warm, _ = self._mega(1)
        warm.body(state, consts, philox_draw(99, salt, sp.V, sp.C))
        plain_ms = cuda_ms(lambda: mega.body(
            state, consts, philox_draw(99, salt, sp.V, sp.C)), 1)
        # generating the noise in the kernel against reading the same
        # draws' worth from noise tensors: phase 1's lanes at two steps
        mega, sp = self._mega(2)
        state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
        g = torch.Generator(self.dev).manual_seed(5)
        sg = 2 * sp.gens
        noise = dict(
            noise=torch.randn((sg, sp.V, sp.C, N), device=self.dev, generator=g),
            rates=torch.exp2(torch.randint(0, 16, (sg, sp.C, N), device=self.dev,
                                           generator=g).float() - 23),
            wipe_u=torch.rand((2, 1, N), device=self.dev, generator=g),
            wipe_g=torch.rand((2, sp.V, N), device=self.dev, generator=g))
        split = {}
        for mode, run in (
                ("philox_ms", lambda: mega(state, consts, seed=99, salt=salt)),
                ("noise_tensor_ms", lambda: mega(state, consts, **noise))):
            run()
            torch.cuda.synchronize()
            split[mode] = cuda_ms(run, 10)
        split.update(lanes=N, n_steps=2,
                     noise_bytes=sum(t.numel() * 4 for t in noise.values()))
        del noise
        emit({"phase": "times", "megastep": rows, "plain_phase1_ms": plain_ms,
              "rng_split": split, "megastep_regularized": reg_rows,
              "ladder_ms": sum(r["ms"] for r in rows),
              "regularized_ladder_ms": sum(r["ms"] for r in reg_rows),
              "philox_call_sass": self.philox_sass, "gpu": smi_line()})
        r0 = rows[0]
        self.kernels["megastep"].update(
            ms=r0["ms"], plain_ms=plain_ms, bound_ms=r0["bound_ms"],
            bound_by=r0["bound_by"], fp32_bound_ms=r0["fp32_bound_ms"],
            int_bound_ms=r0["int_bound_ms"], group=r0["group"],
            regularized_ms=reg_rows[0]["ms"],
            ladder_ms=sum(r["ms"] for r in rows),
            regularized_ladder_ms=sum(r["ms"] for r in reg_rows))
        self._wide_times()
        self._species_times()

    def _wide_rows(self, shapes, kinds, terms=(), robot="dual"):
        """A wide or high-DOF megastep (in-kernel Philox) at each distinct
        (lanes, n_steps) launch shape, CUDA events, at the group size chosen
        and every group size it builds that fits, beside ``bound_ms`` (FP32
        of the TPU cost model's
        counts at this instance's V, K; or bytes) and ``int_bound_ms`` (its
        Philox calls per lane-step, as :meth:`_mega_rows`); one row per
        launch of ``shapes``."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            megastep_flops_per_lane, philox_calls_per_lane_step)

        clocks_per_call, sm_clocks = self._philox_clocks()
        done = {}
        for N, steps in shapes:
            if (N, steps) in done:
                continue
            mega, sp = self._wide(steps, kinds, terms, robot=robot)
            state, consts, _ = self._wide_inputs(sp, steps, N, kinds, terms,
                                                 with_noise=False, robot=robot)
            salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
            G = mega.group(mega._lib(N), self.dev, N)
            by = {}
            for g in self._fitting_groups(mega, N):
                run = lambda: mega(state, consts, seed=99, salt=salt, group=g)  # noqa: E731
                run()
                torch.cuda.synchronize()
                by[g] = cuda_ms(run, 2)
            del state, consts
            V, K, T = sp.V, sp.K, len(self.robots[robot][2])
            flops = megastep_flops_per_lane(sp, steps) * N
            # state in and out, the goal rows (gaux where a kind reads it),
            # bounds, salt
            nbytes = 4 * N * (2 * (5 * V + 2 + 7 * T) + 5 * V + (9 + 3 * mega.has_aux) * K
                              + 2 + (8 * V if terms else 0))
            calls = philox_calls_per_lane_step(sp) * N * steps
            ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            done[N, steps] = {
                "lanes": N, "n_steps": steps, "group": G, "ms": by[G],
                "ms_by_group": by, "gflop": flops / 1e9, "bytes": nbytes,
                "philox_calls": calls, "fp32_bound_ms": ops_ms,
                "int_bound_ms": calls * clocks_per_call / sm_clocks * 1e3,
                "bound_ms": bound, "bound_by": "bytes" if bound == bytes_ms else "operations",
                "ns_per_lane_step": by[G] * 1e6 / (N * steps)}
            torch.cuda.empty_cache()
        return [done[shape] for shape in shapes]

    def _wide_times(self):
        """The wide instance at both dual paths' four ladder launch shapes,
        the high-DOF instances at their paths' launch shapes, and the plain
        version beside the kernel at one
        step on each path's phase-1 lanes (the same Philox bits; the snake:
        a quarter of them)."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import philox_draw
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        snake = [(B_SNAKE * 4 * 2, SNAKE_CHECK)] * (SNAKE_STEPS // SNAKE_CHECK)
        hb = phase_shapes(HB_PHASES, HB_FRACTIONS, B_HB)
        mm = phase_shapes(MM_PHASES, MM_FRACTIONS, B_MM)
        reg = phase_shapes(HB_PHASES, HB_FRACTIONS, B_HIGH_SEC)
        s_kinds = HIGH_DOF["snake"][2]
        h_kinds = HIGH_DOF["humanoid"][2]
        for name, key, robot, kinds, terms, shapes in (
                ("megastep_dual", "pose2", "dual", POSE2_KINDS, (),
                 phase_shapes(DUAL_PHASES, DUAL_FRACTIONS, B_DUAL)),
                ("megastep_dual_sec", "multigoal", "dual", MG_KINDS, REG_TERMS,
                 phase_shapes(MG_PHASES, MG_FRACTIONS, B_MG)),
                ("megastep_snake", "snake32_position", "snake", s_kinds, (), snake),
                ("megastep_snake_sec", "snake32_position_regularized", "snake", s_kinds,
                 REG_TERMS, [(B_HIGH_SEC * 4 * 2, SNAKE_CHECK)]),
                ("megastep_humanoid", "humanoid_whole_body", "humanoid", h_kinds, (), hb),
                ("megastep_humanoid", "humanoid_whole_body_mm", "humanoid", h_kinds, (), mm),
                ("megastep_humanoid_sec", "humanoid_whole_body_regularized", "humanoid",
                 h_kinds, REG_TERMS, reg[:1])):
            out = {"phase": "times", "robot": robot, "path": key, "gpu": smi_line()}
            rows = self._wide_rows(shapes, kinds, terms, robot)
            N = shapes[0][0] if robot != "snake" else shapes[0][0] // 4
            mega, sp = self._wide(1, kinds, terms, robot=robot)
            out["instance"] = [sp.V, sp.K, len(self.robots[robot][2])]
            state, consts, _ = self._wide_inputs(sp, 1, N, kinds, terms, with_noise=False,
                                                 robot=robot)
            salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
            draw = lambda: philox_draw(99, salt, sp.V, sp.C, keep=bool(terms))  # noqa: E731
            mega.body(state, consts, draw())
            plain_ms = cuda_ms(lambda: mega.body(state, consts, draw()), 1)
            mega(state, consts, seed=99, salt=salt)
            torch.cuda.synchronize()
            one_step_ms = cuda_ms(lambda: mega(state, consts, seed=99, salt=salt), 3)
            del state, consts
            torch.cuda.empty_cache()
            r0 = rows[0]
            out.update(rows=rows, ladder_ms=sum(r["ms"] for r in rows),
                       plain_one_step_ms=plain_ms, kernel_one_step_ms=one_step_ms,
                       one_step_lanes=N)
            emit(out)
            if self.kernels[name].get("ms") is not None:     # a second ladder
                self.kernels[name][f"{key}_ladder_ms"] = out["ladder_ms"]
                continue
            self.kernels[name].update(
                ms=r0["ms"], plain_ms=plain_ms, plain_shape=[N, 1],
                ms_at_plain_shape=one_step_ms, bound_ms=r0["bound_ms"],
                bound_by=r0["bound_by"], fp32_bound_ms=r0["fp32_bound_ms"],
                int_bound_ms=r0["int_bound_ms"], group=r0["group"],
                ladder_ms=out["ladder_ms"], shape=[r0["lanes"], r0["n_steps"]])

    def _species_times(self):
        """The species kernel at each species path's launch shape in both
        randomness modes (CUDA events, 10 launches) and its plain version in
        Philox mode (one launch), beside its bounds: ``bound_ms``, the larger
        of the bytes (each input read once, each output written once) and
        the FP32 work (the TPU cost model's FLOPs, one unfused instruction
        each at the card's 128 FP32 instructions per SM and clock: the kernel
        is built -fmad=false), and ``int_bound_ms``, the Philox calls alone
        (as the megastep's); with registers, spill and resident blocks."""
        import ctypes

        import torch
        from bio_ik_tpu_torch.kernels.bio2_step import (
            quat_mask, species_bytes_per_lane, species_flops_per_lane,
            species_philox_calls_per_lane)
        from bio_ik_tpu_torch.kernels.build import load, ptxas_table

        int_clocks, sm_clocks = self._philox_clocks()
        fp32_rate = FP32_PER_SM_CLK * sm_clocks
        lib = load("species")
        lib.species_smem_bytes.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint]
        lib.species_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [ctypes.c_uint] + [
            ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        ptx = {r["entry"]: r for r in ptxas_table("species")}
        rows = []
        for urdf, B, terms in [(u, b, ()) for u, b, _ in SPECIES_PATHS] + [
                (SPECIES_PATHS[0][0], B_SPECIES_SEC, REG_TERMS)]:
            N = B * SPECIES_ISLANDS * 2
            kern, (args, kw) = self._species_args(urdf, N, sec_terms=terms, philox=True)
            sp = kern.sp
            row = {"robot": urdf, "sec_terms": terms, "lanes": N, "V": sp.V}
            for mode, run in (("ms", lambda: kern(*args, seed=99, step=0, **kw)),
                              ("plain_ms", lambda: self._species_philox_plain(
                                  kern, args, kw, 99, 0))):
                run()
                torch.cuda.synchronize()
                row[mode] = cuda_ms(run, 10 if mode == "ms" else 1)
            del args, kw
            kern, targs = self._species_args(urdf, N, sec_terms=terms)
            run = lambda: kern(*targs)  # noqa: E731
            run()
            torch.cuda.synchronize()
            row["noise_tensor_ms"] = cuda_ms(run, 10)
            del targs
            torch.cuda.empty_cache()
            flops = species_flops_per_lane(sp) * N
            ops_ms = flops / fp32_rate * 1e3
            calls = species_philox_calls_per_lane(sp) * N
            for mode in ("philox", "tensors"):
                nbytes = species_bytes_per_lane(sp, terms, rng=mode) * N
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                pre = "" if mode == "philox" else "noise_tensor_"
                row.update({pre + "bytes": nbytes, pre + "bound_ms": max(ops_ms, bytes_ms),
                            pre + "bound_by": ("bytes" if bytes_ms > ops_ms
                                               else "operations")})
            smem = lib.species_smem_bytes(sp.V, sp.K, sp.C, kern.sec_mask)
            blocks = ctypes.c_int(0)
            lib.species_blocks_per_sm(sp.V, sp.K, quat_mask(sp.quat_slices),
                                      int(bool(terms)), 1, smem, ctypes.byref(blocks))
            entry = re.compile(rf"void species_kernel<\(int\){sp.V}, \(int\){sp.K}, .*"
                               rf"\(bool\){int(bool(terms))}, \(int\)1>")      # clt4
            rows_ptx = [r for e, r in ptx.items() if entry.match(e)]
            row.update(gflop=flops / 1e9, fp32_bound_ms=ops_ms, philox_calls=calls,
                       int_bound_ms=calls * int_clocks / sm_clocks * 1e3,
                       smem_bytes=smem, blocks_per_sm=blocks.value,
                       ptxas={k: v for k, v in (rows_ptx[0] if rows_ptx else {}).items()
                              if k != "entry"},
                       ns_per_lane=row["ms"] * 1e6 / N)
            rows.append(row)
        emit({"phase": "times", "species": rows, "gpu": smi_line()})
        r0 = rows[0]
        self.kernels["species"].update(
            ms=r0["ms"], plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
            bound_by=r0["bound_by"], int_bound_ms=r0["int_bound_ms"],
            noise_tensor_ms=r0["noise_tensor_ms"],
            noise_tensor_bound_ms=r0["noise_tensor_bound_ms"],
            registers=r0["ptxas"].get("registers"),
            spill_stores=r0["ptxas"].get("spill_stores", 0),
            regularized_ms=rows[-1]["ms"],
            regularized_noise_tensor_ms=rows[-1]["noise_tensor_ms"])

    # ------------------------------------------------------------ sec --
    def sec_check(self):
        """The secondary-goal instances against their plain versions: the
        megastep at the regularized path's phase-1 lanes (two steps) in
        noise-tensor and in-kernel Philox mode (keep draw included), with
        the regularized path's terms and with all four; the species kernel
        with the same terms at species path (b)'s launch shape, bitwise.

        With the regularized path's terms also the floor between two correct
        versions (the plain version on the CPU against itself on the card,
        on the same lanes and inputs) and two controls, wrong versions that
        the comparison must fail: the plain version without the
        pre-selection (every keep uniform 1, so all C children are kept),
        and without the secondary terms in the memetic search (keep 1 on
        both sides, the plain version's secondary coefficients 0)."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import (array_draw,
                                                            philox_draw)
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        N = phase_shapes(REG_PHASES, REG_FRACTIONS)[0][0]
        out = {"phase": "sec_check", "lanes": N}
        fracs, errs, controls, groups_bitwise = [], [], [], []
        for terms in (REG_TERMS, ALL_TERMS):
            mega, sp = self._mega(2, sec_terms=terms)
            state, consts, noise = self._inputs(sp, 2, N, sec_terms=terms)

            def kernel(keep, group=None):
                return mega(state, consts, noise=noise[0], rates=noise[1],
                            wipe_u=noise[2], wipe_g=noise[3], keep=keep, group=group)

            def plain(body, st, cs, nz, keep):
                return body(st, cs, array_draw(*nz[:4], sp.gens, keep=keep))

            k_out = kernel(noise[4])
            p_out = plain(mega.body, state, consts, noise, noise[4])
            torch.cuda.synchronize()
            agree = lane_agreement(k_out, p_out)
            frac = float(agree.float().mean())
            err = max(max_abs_err(a, b, agree) for a, b in zip(k_out, p_out))
            row = {"noise_tensor_agree_frac": frac,
                   "group_chosen": mega.group(mega._lib(N), self.dev, N)}
            # every group size G: the same bits as G = 1
            g1 = kernel(noise[4], 1)
            row["group_bitwise_vs_g1_frac"] = {
                G: bitwise_frac(kernel(noise[4], G), g1, N) for G in mega.groups}
            groups_bitwise.append(min(row["group_bitwise_vs_g1_frac"].values()))
            del g1
            if terms == REG_TERMS:
                cpu_mega, _ = self._mega(2, sec_terms=terms, model=self.cpu_model)
                cs, cc, cn = [tuple(t.cpu() for t in x) for x in (state, consts, noise)]
                row["plain_cpu_vs_card_agree_frac"] = agree_frac(
                    plain(cpu_mega.body, cs, cc, cn, cn[4]), p_out)
                del cs, cc, cn
                ones = torch.ones_like(noise[4])
                row["control_no_preselection_agree_frac"] = agree_frac(
                    k_out, plain(mega.body, state, consts, noise, ones))
                coef0 = consts[-1].clone()
                coef0[:4 * sp.V] = 0.0
                row["control_no_sec_in_memetic_agree_frac"] = agree_frac(
                    kernel(ones), plain(mega.body, state, consts[:-1] + (coef0,),
                                        noise, ones))
                controls += [row["control_no_preselection_agree_frac"],
                             row["control_no_sec_in_memetic_agree_frac"]]
                del ones, coef0
            del noise, k_out, p_out
            state, consts, _ = self._inputs(sp, 2, N, with_noise=False,
                                            sec_terms=terms)
            salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
            k1 = mega(state, consts, seed=4321, salt=salt)
            p1 = mega.body(state, consts,
                           philox_draw(4321, salt, sp.V, sp.C, keep=True))
            torch.cuda.synchronize()
            frac_p = agree_frac(k1, p1)
            row.update(philox_agree_frac=frac_p, agree_max_abs_err=err)
            out["megastep_" + "_".join(terms)] = row
            fracs += [frac, frac_p]
            errs.append(err)
        # the species kernel with the secondary terms, bitwise
        Ns = B_SPECIES_SEC * SPECIES_ISLANDS * 2
        bitwise = []
        for terms in (REG_TERMS, ALL_TERMS):
            kern, args = self._species_args("free_arm.urdf", Ns, sec_terms=terms)
            k_out = kern(*args)
            p_out = kern.inner(*args)
            torch.cuda.synchronize()
            bw = float(torch.stack([(a == b).reshape(-1, Ns).all(0)
                                    for a, b in zip(k_out, p_out)]).all(0)
                       .float().mean())
            out["species_" + "_".join(terms)] = {"lanes": Ns, "bitwise_frac": bw}
            bitwise.append(bw)
            del args, k_out, p_out
        emit(out)
        self.kernels["megastep"]["sec_agree_frac"] = min(fracs)
        self.kernels["species"]["sec_bitwise_frac"] = min(bitwise)
        if min(fracs) < 0.85:
            raise AssertionError(f"secondary megastep agrees on {min(fracs):.3f} "
                                 "of lanes (< 0.85)")
        if min(groups_bitwise) < 1.0:
            raise AssertionError("a group size changes the secondary megastep's "
                                 f"result: {groups_bitwise}")
        if max(controls) >= 0.85:
            raise AssertionError(f"a wrong secondary branch agrees on {max(controls):.3f}"
                                 " of lanes: the 0.85 limit cannot tell it apart")
        if min(bitwise) < 1.0:
            raise AssertionError("the species kernel with secondary terms is "
                                 f"bitwise equal on only {min(bitwise)} of lanes")
        self._wide_fk_check("megastep_dual_sec", MG_KINDS, REG_TERMS)
        row = self._wide_check(MG_KINDS, REG_TERMS)
        emit({"phase": "sec_check", "instance": [17, 2, 2], **row})
        self.kernels["megastep_dual_sec"].update(
            agree_frac=row["agree_frac"], philox_agree_frac=row["philox_agree_frac"],
            floor_agree_frac=row["plain_cpu_vs_card_agree_frac"])
        self._high_checks("sec_check", sec=True)

    # ------------------------------------------------------- fullstep --
    def fullstep_check(self):
        """The fullstep kernel (one bio2 step, no bookkeeping) against the
        plain make_fullstep_inner at phase 1's 131 072 lanes in both RNG
        modes, and its time beside its bound."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_fullstep import array_draw_gen
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            Fullstep, fullstep_bytes_per_lane, megastep_flops_per_lane,
            philox_draw)
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        N = phase_shapes()[0][0]
        sp = SpeciesParams(V=7, K=1)
        fs = Fullstep(self.model, [TIP], list(range(7)), [0], sp)
        state, consts, noise = self._inputs(sp, 1, N, seed=13)
        args = (state[0], state[1]) + tuple(consts[:8])
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2

        def noise_run():
            return fs(*args, noise=noise[0], rates=noise[1])

        def philox_run():
            return fs(*args, seed=77, salt=salt)

        def plain_noise():
            return fs.inner(*args, array_draw_gen(noise[0], noise[1]))

        k_out, p_out = noise_run(), plain_noise()
        k2 = philox_run()
        p2 = fs.inner(*args, philox_draw(77, salt, sp.V, sp.C)(0)[0])
        torch.cuda.synchronize()
        agree = lane_agreement(k_out, p_out)
        frac = float(agree.float().mean())
        frac_p = float(lane_agreement(k2, p2).float().mean())
        err = max(max_abs_err(a, b, agree) for a, b in zip(k_out, p_out))
        # the floor in both modes: the plain version on the CPU against
        # itself on the card, on the first 4 096 lanes (lanes are independent)
        n = 4096
        cut = [a[..., :n].cpu() for a in args]
        cpu_fs = Fullstep(self.cpu_model, [TIP], list(range(7)), [0], sp)
        floor = float(lane_agreement([x[..., :n] for x in p_out], cpu_fs.inner(
            *cut, array_draw_gen(noise[0][..., :n].cpu(), noise[1][..., :n].cpu())))
            .float().mean())
        floor_p = float(lane_agreement([x[..., :n] for x in p2], cpu_fs.inner(
            *cut, philox_draw(77, salt[..., :n].cpu(), sp.V, sp.C)(0)[0]))
            .float().mean())
        # the kernel driven on its own (no comparison): counted launches
        torch.cuda.synchronize()
        Fullstep.launches = 0
        ms = cuda_ms(noise_run, 10)
        ms_p = cuda_ms(philox_run, 10)
        launches = Fullstep.launches
        plain_ms = cuda_ms(plain_noise, 1)
        flops = megastep_flops_per_lane(sp, 1) * N
        nbytes = fullstep_bytes_per_lane(sp, 0) * N
        nbytes_p = nbytes - 4 * N * (sp.gens * sp.V * sp.C + sp.gens * sp.C)
        ops_ms = flops / PEAK_FP32 * 1e3
        bound = max(ops_ms, nbytes / PEAK_BYTES * 1e3)
        bound_p = max(ops_ms, nbytes_p / PEAK_BYTES * 1e3)
        out = {"phase": "fullstep_check", "lanes": N,
               "noise_tensor_agree_frac": frac, "philox_agree_frac": frac_p,
               "plain_cpu_vs_card_agree_frac": floor,
               "plain_cpu_vs_card_philox_agree_frac": floor_p,
               "agree_max_abs_err": err, "launches_timed": launches,
               "noise_tensor_ms": ms, "philox_ms": ms_p, "plain_ms": plain_ms,
               "flop_per_lane": megastep_flops_per_lane(sp, 1),
               "noise_tensor_bytes": nbytes, "noise_tensor_bound_ms": bound,
               "noise_tensor_bound_by": "bytes" if bound > ops_ms else "operations",
               "philox_bytes": nbytes_p, "philox_bound_ms": bound_p,
               "philox_bound_by": "bytes" if bound_p > ops_ms else "operations",
               "gpu": smi_line()}
        emit(out)
        self.kernels["fullstep"].update(
            launches=launches, agree_frac=min(frac, frac_p), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=out["noise_tensor_bound_by"], philox_ms=ms_p,
            philox_bound_ms=bound_p)
        if min(frac, frac_p) < 0.85:
            raise AssertionError(f"fullstep kernel agrees on {frac:.3f} / "
                                 f"{frac_p:.3f} of lanes (< 0.85)")
        for robot in ("dual", "humanoid", "snake"):
            self._wide_fullstep_check(robot)
        self._wide_kinds_fk_check()
        self._wide_kinds_fk_check("humanoid")

    def _wide_kinds_fk_check(self, robot="dual"):
        """Every goal kind's exact evaluator in a wide or high-DOF megastep:
        no selection (zero generations, no memetic, one step) with PoseGoals
        on the other tips (the dual arm's right gripper, the humanoid's
        hands) and an instance of the kind at weight 1 on the last one (the
        left gripper, the head), parents FK_SPREAD rad about q* (clipped to
        the bounds), on every lane of the multigoal path's first launch
        (the humanoid: N_HIGH_FK lanes).  The incumbent then
        holds parent 0's exact FK tips and fitness: the kernel's
        max_abs_err against the plain version (atol 1e-5).  The controls,
        the plain version with the kind swapped for KIND_CONTROL's and, for
        the cone, with torch.atan2 in place of the Hastings polynomial, must
        miss the kernel's fitness by more than that."""
        from unittest import mock

        import torch
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels import bio2_fullstep
        from bio_ik_tpu_torch.kernels.bio2_fullstep import LINK_KINDS
        from bio_ik_tpu_torch.kernels.bio2_megastep import array_draw
        from bio_ik_tpu_torch.kernels.checks import max_abs_err, megastep_inputs

        _, cpu, tips = self.robots[robot]
        N = (phase_shapes(MG_PHASES, MG_FRACTIONS, B_MG)[0][0] if robot == "dual"
             else N_HIGH_FK)
        base = ("pose",) * (len(tips) - 1)
        out = {"phase": "fullstep_check", "robot": robot,
               "instance": [cpu.nvars, len(tips), len(tips)], "fk_lanes": N,
               "fk_spread": FK_SPREAD, "fk_miss": FK_MISS}
        worst = 0.0
        for kind in LINK_KINDS:
            kinds = base + (kind,)
            mega, sp = self._wide(1, kinds, gens=0, mem_iters=0, memetic="", robot=robot)
            other, _ = self._wide(1, base + (KIND_CONTROL[kind],), gens=0, mem_iters=0,
                                  memetic="", robot=robot)
            state, consts, noise = tree_from_numpy(megastep_inputs(
                cpu, list(tips), sp, 1, N, 11, spread=FK_SPREAD,
                inst_kind=list(kinds), miss=FK_MISS), self.dev)
            k = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
                     wipe_g=noise[3])
            draw = array_draw(*noise, 0)
            p = mega.body(state, consts, draw)
            c = other.body(state, consts, draw)
            row = {"fk_fit_max_abs_err": max(max_abs_err(k[5], p[5]),
                                             max_abs_err(k[4], p[4])),
                   "control_kind": KIND_CONTROL[kind],
                   "control_fit_max_abs_err": max_abs_err(k[4], c[4])}
            controls = [row["control_fit_max_abs_err"]]
            if kind == "cone":
                with mock.patch.object(bio2_fullstep, "_atan2_nonneg", torch.atan2):
                    e = mega.body(state, consts, draw)
                row["control_exact_atan2_fit_max_abs_err"] = max_abs_err(k[4], e[4])
                controls.append(row["control_exact_atan2_fit_max_abs_err"])
            out[kind] = row
            worst = max(worst, row["fk_fit_max_abs_err"])
            if not row["fk_fit_max_abs_err"] <= 1e-5:
                raise AssertionError(f"{robot} exact FK/fitness with {kind} disagree: {row}")
            if not min(controls) > 1e-5:
                raise AssertionError(f"the {kind} exact-fitness check cannot tell a "
                                     f"wrong plain version apart: {row}")
        emit(out)
        entry = self.kernels[f"megastep_{robot}"]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), worst)

    def _wide_fullstep_check(self, robot="dual"):
        """The fullstep of a wide or high-DOF instance against
        make_fullstep_inner on N_WIDE_CHECK lanes (noise tensors and
        Philox), beside the floor (the plain version on the CPU against
        itself on the card, first N_WIDE_FLOOR lanes) and wrong plain
        versions: on the dual arm once per non-pose goal kind (a PoseGoal on
        the right gripper, the kind on the left one), on the humanoid pose
        only and then once per non-pose kind on the head (PoseGoals on the
        hands), on the snake its PositionGoal (rows that miss, so each term
        acts: checks.megastep_inputs).  The controls: the instances' tips
        permuted (one tip: one joint's axis negated in the plain chain);
        with a non-pose kind its term dropped (its weight zeroed) and the
        kind swapped for KIND_CONTROL's; with the pose family only, the
        rotation weights zeroed (none: the position term dropped).  Then
        its time at ``time_lanes`` (the multigoal path's phase-1 lanes on
        the dual arm, the humanoid path's on the others) beside its bound
        and the plain version's time."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_fullstep import LINK_KINDS, array_draw_gen
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            Fullstep, fullstep_bytes_per_lane, megastep_flops_per_lane, philox_draw)
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
        from bio_ik_tpu_torch.kernels.checks import (HIGH_DOF, axis_negated,
                                                     lane_agreement, max_abs_err)

        card, cpu, tips = self.robots[robot]
        V = card.nvars
        if robot == "dual":
            runs = [("pose", kind) for kind in LINK_KINDS]
            path_kinds, time_lanes = MG_KINDS, phase_shapes(MG_PHASES, MG_FRACTIONS, B_MG)[0][0]
        else:
            path_kinds = HIGH_DOF[robot][2]
            runs = [path_kinds] + [path_kinds[:-1] + (kind,) for kind in LINK_KINDS
                                   if len(path_kinds) > 1]
            time_lanes = phase_shapes(HB_PHASES, HB_FRACTIONS, B_HB)[0][0]
        N, n = N_WIDE_CHECK, N_WIDE_FLOOR
        out = {"phase": "fullstep_check", "robot": robot,
               "instance": [V, len(path_kinds), len(tips)], "lanes": N}
        worst, controls, errs = 1.0, [], []
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2

        def fullstep(kinds, model=None, inst_tip=None):
            K = len(kinds)
            return Fullstep(model or card, list(tips), list(range(V)),
                            list(range(K) if inst_tip is None else inst_tip),
                            SpeciesParams(V=V, K=K), inst_kind=list(kinds))

        for kinds in runs:
            K = len(kinds)
            fs = fullstep(kinds)
            sp = fs.sp
            state, consts, noise = self._wide_inputs(sp, 1, N, kinds, seed=13, robot=robot)
            args = (state[0], state[1]) + tuple(consts[:-2])
            k_out = fs(*args, noise=noise[0], rates=noise[1])
            p_out = fs.inner(*args, array_draw_gen(noise[0], noise[1]))
            k2 = fs(*args, seed=77, salt=salt)
            p2 = fs.inner(*args, philox_draw(77, salt, sp.V, sp.C)(0)[0])
            torch.cuda.synchronize()
            cut = lambda xs: tuple(x[..., :n].cpu() for x in xs)  # noqa: E731
            c_out = fullstep(kinds, cpu).inner(*cut(args), array_draw_gen(*cut(noise[:2])))
            agree = lane_agreement(k_out, p_out)
            errs.append(max(max_abs_err(a, b, agree) for a, b in zip(k_out, p_out)))
            row = {"agree_frac": float(agree.float().mean()),
                   "philox_agree_frac": agree_frac(k2, p2),
                   "plain_cpu_vs_card_agree_frac": agree_frac(c_out, cut(p_out))}
            row["agree_limit"] = min(0.85, row["plain_cpu_vs_card_agree_frac"] - 0.03)
            names = [nm for nm, _ in fs.rows]
            wrong = {}
            if K > 1:
                wrong["tips_permuted"] = (fullstep(kinds, inst_tip=tuple(range(1, K)) + (0,)),
                                          args)
            else:
                wrong["axis_negated"] = (fullstep(kinds, axis_negated(card, V // 2)), args)
            if kinds[-1] in LINK_KINDS:
                dropped = list(args)
                i = names.index("wpos")
                dropped[i] = dropped[i].clone()
                dropped[i][K - 1] = 0.0
                wrong["term_dropped"] = (fs, dropped)
                wrong["kind_swapped"] = (fullstep(kinds[:-1] + (KIND_CONTROL[kinds[-1]],)),
                                         args)
            else:
                i = names.index("wrot")
                label = "rotation_weight_zero" if bool((args[i] != 0).any()) else None
                if label is None:
                    i, label = names.index("wpos"), "position_term_dropped"
                zeroed = list(args)
                zeroed[i] = torch.zeros_like(zeroed[i])
                wrong[label] = (fs, zeroed)
            for label, (f, a) in wrong.items():
                row[f"control_{label}_agree_frac"] = agree_frac(
                    k_out, f.inner(*a, array_draw_gen(noise[0], noise[1])))
                controls.append(row[f"control_{label}_agree_frac"])
            out["+".join(kinds)] = row
            if min(row["agree_frac"], row["philox_agree_frac"]) < row["agree_limit"]:
                raise AssertionError(f"{robot} fullstep with {kinds} below its limit: {row}")
            worst = min(worst, row["agree_frac"], row["philox_agree_frac"])
            del state, consts, noise, args, k_out, p_out, k2, p2
        out["control_limit"] = CONTROL_LIMIT
        if max(controls) >= CONTROL_LIMIT:
            raise AssertionError(f"a wrong plain version agrees with the {robot} "
                                 f"fullstep: {out}")
        # its time on the path's kinds, counted launches
        N = time_lanes
        fs = fullstep(path_kinds)
        sp = fs.sp
        state, consts, noise = self._wide_inputs(sp, 1, N, path_kinds, seed=13, robot=robot)
        args = (state[0], state[1]) + tuple(consts[:-2])
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
        noise_run = lambda: fs(*args, noise=noise[0], rates=noise[1])  # noqa: E731
        philox_run = lambda: fs(*args, seed=77, salt=salt)  # noqa: E731
        noise_run(), philox_run()
        torch.cuda.synchronize()
        Fullstep.launches = 0
        ms, ms_p = cuda_ms(noise_run, 10), cuda_ms(philox_run, 10)
        launches = Fullstep.launches
        plain_ms = cuda_ms(lambda: fs.inner(*args, array_draw_gen(noise[0], noise[1])), 1)
        flops = megastep_flops_per_lane(sp, 1) * N
        nbytes = (fullstep_bytes_per_lane(sp, 0) + 4 * 3 * sp.K * fs.has_aux) * N  # + gaux
        nbytes_p = nbytes - 4 * N * (sp.gens * sp.V * sp.C + sp.gens * sp.C)
        ops_ms = flops / PEAK_FP32 * 1e3
        bound = max(ops_ms, nbytes / PEAK_BYTES * 1e3)
        bound_p = max(ops_ms, nbytes_p / PEAK_BYTES * 1e3)
        out.update(time_lanes=N, noise_tensor_ms=ms, philox_ms=ms_p, plain_ms=plain_ms,
                   launches_timed=launches, noise_tensor_bound_ms=bound,
                   philox_bound_ms=bound_p, gpu=smi_line())
        emit(out)
        self.kernels[f"fullstep_{robot}"].update(
            launches=launches, agree_frac=worst, max_abs_err=max(errs), ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if bound > ops_ms else "operations", philox_ms=ms_p,
            philox_bound_ms=bound_p, lanes=N)
        del state, consts, noise, args
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ mfu --
    def mfu(self):
        """Path (d): ``python -m bio_ik_tpu_torch.tools.bench_mfu``'s
        measurements; then the peak kernel bitwise against its plain version
        on bench_mfu's own input, (256, 8192) into a (256, 512) tile, at both
        of its iteration counts — there only the last column block's threads
        store, the rule a one-block tile never tests — and at T = 64 on a
        one-block (256, 512) tile."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch.kernels.peak import (PeakChains, peak_chains_plain,
                                                   peak_flops)
        from bio_ik_tpu_torch.tools import bench_mfu

        PeakChains.launches = 0
        res = bench_mfu.run()
        launches = PeakChains.launches
        R, W, G_ = bench_mfu.PEAK_R, bench_mfu.PEAK_W, bench_mfu.PEAK_G
        T = bench_mfu.PEAK_T[0]
        xs = torch.as_tensor(np.random.default_rng(0).uniform(
            0.2, 0.8, size=(R, W * G_)).astype(np.float32), device=self.dev)
        peak_chains_plain(xs, 4, W)
        plain_ms = cuda_ms(lambda: peak_chains_plain(xs, T, W), 1)
        # the bound: 3 unfused FP32 instructions per iteration and chain
        # (peak_flops; held against the SASS of the loop) at 128 per SM and
        # clock, beside the FMA-counted data-sheet time
        _, sm_clocks = self._philox_clocks()
        loops = peak_sass_loops()
        bound = peak_flops(R, W * G_, T) / (FP32_PER_SM_CLK * sm_clocks) * 1e3
        fma_bound = peak_flops(R, W * G_, T) / PEAK_FP32 * 1e3
        bitwise, errs = {}, []
        for t in bench_mfu.PEAK_T:
            k, p = PeakChains()(xs, t, W), peak_chains_plain(xs, t, W)
            bitwise[f"{R}x{W * G_}_T{t}"] = bool(torch.equal(k, p))
            errs.append(float((k - p).abs().max()))
        x = torch.as_tensor(np.random.default_rng(1).uniform(
            0.2, 0.8, size=(256, 512)).astype(np.float32), device=self.dev)
        bitwise["256x512_T64"] = bool(torch.equal(PeakChains()(x, 64, 512),
                                                  peak_chains_plain(x, 64, 512)))
        emit({"phase": "mfu", **res, "peak_bitwise": bitwise,
              "peak_max_abs_err": max(errs), "peak_launches": launches,
              "peak_plain_ms_T1024": plain_ms, "peak_bound_ms_T1024": bound,
              "peak_fma_counted_bound_ms_T1024": fma_bound,
              "peak_sass_loops_fp32": loops})
        ms = res["peak_ms_by_iterations"][str(T)]
        ok = all(bitwise.values())
        self.kernels["peak"].update(
            launches=launches, max_abs_err=max(errs), agree_frac=1.0 if ok else 0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
            fma_counted_bound_ms=fma_bound, sass_loops_fp32=loops)
        if any(lp["FFMA"] or (lp["FMUL"] + lp["FADD"]) % 24 for lp in loops):
            raise AssertionError(f"the peak loop is not 3 unfused FP32 instructions "
                                 f"per iteration of its 8 chains: {loops}")
        if not ok:
            raise AssertionError(f"the peak kernel differs from its plain version: {bitwise}")
        if not (res["vpu_fma_peak_tflops"] > 0 and res["kernel_chunk_ms"] > 0):
            raise AssertionError(f"bench_mfu measured nothing: {res}")

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="build,check,rng,sec_check,fullstep_check,"
                    "main,regularized_main,dual_main,multigoal_main,snake_main,"
                    "humanoid_main,species_check,species_main,species_sec_main,times,"
                    "profile,mfu",
                    help="comma-separated phases to run")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs the card")
    sys.path.insert(0, ROOT)
    try:
        import bio_ik_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: the bio_ik_tpu_torch package is missing ({e})")
    smoke = Smoke()
    phases = args.only.split(",")
    for name in phases:
        t0 = time.perf_counter()
        getattr(smoke, name)()
        emit({"phase_seconds": {name: time.perf_counter() - t0}})
    k = smoke.kernels
    emit({"kernels": [dict(
        name=name, route="cuda", source=f"bio_ik_tpu_torch/csrc/{src}.cu",
        replaces=replaces, launches=k[name].get("launches"),
        max_abs_err=k[name].get("max_abs_err"), ms=k[name].get("ms"),
        plain_ms=k[name].get("plain_ms"), bound_ms=k[name].get("bound_ms"),
        bound_by=k[name].get("bound_by"), library_ms=None,
        **{x: v for x, v in k[name].items() if x not in KERNEL_KEYS})
        for name, src, replaces in (
            ("megastep", "megastep", MEGASTEP_TPU),
            ("megastep_dual", "megastep_wide", MEGASTEP_TPU),
            ("megastep_dual_sec", "megastep_wide", MEGASTEP_TPU),
            ("megastep_snake", "megastep_high", MEGASTEP_TPU),
            ("megastep_snake_sec", "megastep_high", MEGASTEP_TPU),
            ("megastep_humanoid", "megastep_high", MEGASTEP_TPU),
            ("megastep_humanoid_sec", "megastep_high", MEGASTEP_TPU),
            ("species", "species", "bio_ik_tpu/kernels/bio2_step.py:461"),
            ("fullstep", "megastep", FULLSTEP_TPU),
            ("fullstep_dual", "megastep_wide", FULLSTEP_TPU),
            ("fullstep_snake", "megastep_high", FULLSTEP_TPU),
            ("fullstep_humanoid", "megastep_high", FULLSTEP_TPU),
            ("peak", "peak", "tools/bench_mfu.py:85"))]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
