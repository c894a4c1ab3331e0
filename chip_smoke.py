#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase (what CI runs)
    python3 chip_smoke.py --only build,check

Drives ``bio_ik_tpu_torch`` (never JAX) through its paths — the fullstep
tier (bench.py's configuration, the reference's recommended regularized
one, the JAX suite's two PR2 dual-arm rows on the wide megastep instance
and its snake-32 and humanoid rows on the high-DOF instances, shapes that
no prebuilt source holds on instances generated on first use, latency
mode and the island path of the single-query entry points), the species tier
(floating and planar chains, with and without the regularizers), the JAX
suite's UR5 and KUKA rows through the port's bench_suite, the sharded
solves in a world of one and of two, the float64 native FK oracle and the
FP32 peak calibration — and holds each hand-written CUDA kernel against
its plain torch version.  Phases, each
printing one JSON line and its seconds; any failure raises and exits
non-zero:

  build           — card name and power limit, torch/CUDA versions, nvcc
                    build of every kernel source (megastep.cu,
                    megastep_wide.cu, megastep_high.cu, species.cu,
                    peak.cu, and the sources generated for GEN_CASES'
                    and GEN_SPECIES' shapes, all started together in the
                    background while the KERNEL_FREE phases run, and
                    reported before the first phase that launches a
                    kernel), each
                    source's nvcc seconds, their ptxas reports and, per
                    kernel instance, registers, stack and spill; the
                    wide, high-DOF and generated instances' shared
                    memory per block at every group size (the Python
                    copy of the layout held equal to the header's) and
                    resident blocks at each one built (or "does not
                    fit");
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
                    fits, exact FK and fitness on 131 072 lanes; the
                    prebuilt (6, 1, 1) instance (UR5's tool0, the JAX
                    suite's ur5_pose row) likewise at that row's first
                    launch's 131 072 lanes (controls: one joint's axis
                    negated, the rotation weights zeroed), every G
                    bitwise equal to G = 1;
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
  latency_check   — the narrow megastep at latency mode's launches (one
                    query: 8 lanes, and 64 at 32 islands; the group size
                    the wrapper picks) vs its plain version in Philox mode,
                    pooled over 4 096 lanes of launches with distinct salts,
                    against its CPU-vs-card floor; every launch bitwise equal
                    to G = 1; its time at those shapes beside its bounds;
  fullstep_check  — the fullstep kernel vs make_fullstep_inner at 131 072
                    lanes in both RNG modes (≥ 85 %), its time and bound;
                    the wide fullstep once per non-pose goal kind beside a
                    PoseGoal, each against its floor; the high-DOF
                    fullsteps (the humanoid also once per non-pose kind
                    on the head, and every kind's exact fitness);
  shapes_check    — the instances generated on first use (the arm's pose +
                    lookat (7, 2, 1) and lookat alone on the wide layout
                    (7, 1, 1), the dual arm's two poses + head lookat with
                    the regularizers (17, 3, 3), the humanoid's two hands
                    (30, 2, 2)) against their plain versions as the wide
                    instances in `check` (exact FK and fitness, lane
                    agreement over two steps against the CPU-vs-card
                    floor, two wrong plain versions, every group size
                    bitwise equal to the smallest, Philox mode) and their
                    fullstep entries; the species (10, 2, 8) instance
                    bitwise in both modes at 131 072 lanes;
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
  shapes_main     — five paths on generated instances, each through the
                    entry points a user calls: (i) pr2_arm PositionGoal +
                    LookAtGoal at 1 cm, the main ladder, B = 65 536; (ii)
                    pr2_dual's two PoseGoals, the head's LookAtGoal at the
                    grippers' midpoint and the regularizers at 0.1, dtwist
                    1 cm, the dual ladder, B = 16 384; (iii) free_arm
                    PositionGoal + OrientationGoal (5 mm, 5 mrad) on the
                    species tier, B = 16 384: success against its bar
                    (JAX_SHAPES_SUCCESS), median errors, the lookat error
                    and secondary fitness beside ablations, launches per
                    solve_batch (4; 16), ms per batch, device idle; (iv)
                    pr2_arm's LookAtGoal alone (B = 65 536) and (v) the
                    humanoid's two hands (B = 16 384): success, errors,
                    launches, ms per batch;
  latency         — latency mode and the single-query entry points through
                    tools/bench_latency (PR2, PoseGoal at 1 mm, 200 targets):
                    IKSolver.solve_until at steps_per_check 4, 8, 16, 32
                    (success ≥ 0.995, one megastep launch per chunk),
                    solve_batch at B = 1, the 1 / 5 / 20 ms wall-clock
                    deadlines and their device-step budgets at 32 islands
                    on the first 50 targets (≥ 0.99 at 20 ms), the island
                    path's success on 50
                    targets at 64 steps (within 0.1 of the JAX package's)
                    and IKSolver.solve's time on 1, solve / search /
                    solve_until of each bio2
                    mode, bio1, gd_4, jac, test, optlib_lbfgs,
                    optlib_nm_r_4, bio2_memetic_lbfgs, neural and
                    neural2, and with elite_migration, a
                    query's prep / kernel / glue split, the prep's
                    synchronizing copies and none inside a chunk,
                    the device's idle share;
  native          — the port's float64 C++ oracle (bio_ik_tpu_torch.native,
                    built with g++ while nvcc compiles): the card's float32
                    FK within 3e-6 of it on 4 096 configurations each of
                    pr2_arm and the humanoid (position; quaternion up to
                    sign), its support point equal to an argmax of the dot
                    product on a random hull;
  suite           — the JAX suite's ur5_pose (the (6, 1, 1) instance, its
                    ladder (1,8),(2,32),(4,64),(8,64)) and kuka_iiwa_pose
                    (tight bounds) rows through
                    python -m bio_ik_tpu_torch.tools.bench_suite's
                    run_config at B = 65 536, its JSON lines: success
                    ≥ 0.999, median position error ≤ 1.8e-6 / 9.7e-7 m,
                    4 / 3 megastep launches per solve_batch;
  parallel        — the sharded solves of bio_ik_tpu_torch.parallel through
                    tools/parallel_check: a world of one over NCCL (the
                    batch-sharded solve at B = 65 536 bitwise solve_batch;
                    the fused island-sharded solve of 8 single queries,
                    success ≥ 0.99 and bitwise the single query, and with
                    migration; the island path's at 4 steps bitwise
                    IKSolver.solve), then a world of two over gloo on the
                    one card, two spawned processes (the batch-sharded
                    result at B = 8 192 bitwise the halves' solve_batch;
                    the island-sharded solve with migration the same on
                    both ranks, below the seed's fitness); launches and ms
                    per row;
  unfused_modes   — the island path's other solvers through
                    IKSolver.solve_batch on the JAX package's records:
                    Table B's 64 PR2 targets (gd_c_4 in float64 at 256
                    steps, jac_4 at 32) and the suite's UR5 rows at B = 512
                    (ur5_pose_bio1, ur5_pose_gd4): success against the
                    JAX anchor − 3·SE (gd4: median error ≤ 3× its
                    anchor), median and p90 position and rotation error,
                    ms per step, launches per step and device idle of a
                    profiled 2-step solve, no hand-written kernel
                    launched; a
                    test-mode solve's linearizer errors;
  other_modes     — the last solver modes through IKSolver.solve_batch on
                    Table B's 64 PR2 targets at the JAX tests' step
                    budgets: optlib lbfgs, bfgs, lbfgsb, gd, cgd, nd, nm
                    and lbfgs_r (islands 4), bio2_memetic_lbfgs, neural
                    and neural2 (trained 2 000 steps at construction):
                    the fields of unfused_modes, neural's training
                    seconds and final loss, lbfgsb's violation of the
                    box, each row against its bar; the drot acceptance
                    at 0.03° on the targets rotated by 1.0 mrad (all
                    rejected) and 0.2 mrad (all accepted);
  island_kinds    — touch (mesh and box), balance, link_function and
                    joint_function: fitness on the card against the CPU
                    plain path at 256 configurations (1e-5 relative
                    beside 1e-9 absolute), an island solve_batch
                    (bio2_memetic, B = 256, 16 steps) of a PoseGoal
                    beside each, counter=True on solve_until
                    (fused and island branches), params.solver_from_spec
                    building the hand-built problem;
  regularized_main — PoseGoal + MinimalDisplacementGoal(0.05) +
                    AvoidJointLimitsGoal(0.05) on bench_suite's ladder at
                    B = 65 536: the same fields, the median secondary fitness
                    beside a pose-only solve of the same targets, and
                    IKSolver.for_tips building the same problem;
  species_check   — species kernel vs plain version in both randomness
                    modes (noise tensors; in-kernel Philox against
                    make_species_inner on philox_draw's tensors): free_arm
                    (524 288 lanes), planar_arm and the secondary-goal
                    instance (131 072) at their paths' launches, bitwise
                    under CLT4;
                    Box–Muller by lane agreement beside its CPU-vs-card
                    floor; by stage, and the noise-tensor floor;
  species_main    — the JAX suite's free_arm_floating_base row at B = 65 536,
                    then planar_arm at B = 16 384: the main fields (16
                    launches), unit quaternions, peak memory;
  species_sec_main — free_arm with the two regularizers at B = 16 384;
  times           — every kernel instance at its paths' launch shapes (CUDA
                    events; the megastep at the 8 ladder launches with the
                    G chosen, every G at the first; the species kernel in
                    both modes with registers, spill and resident blocks)
                    beside its plain version, its FLOP/byte bound and the
                    bound of the generator's integer work (its Philox
                    calls, one call's SASS counted, at the card's IMAD, ALU
                    and issue rates);
                    the (6, 1, 1) instance at ur5_pose's four launch
                    shapes, the wide instance at both dual paths' launch shapes,
                    the high-DOF ones at snake_main's and humanoid_main's,
                    the generated ones at their paths' first launch
                    (every G that fits at each path's first shape);
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
# the other paths time one queue of batches
EARLIER_REPEATS = 1
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
# latency mode (IKSolver.solve_until on the megastep, one query a call):
# the lanes of one launch — 1 query × 4 islands × 2 species, and × 32
# islands (bench_latency.run_deadline_device) —, the lanes pooled over
# launches with distinct salts for the agreement, the lanes of its floor,
# and the launch shapes (lanes, steps_per_check) the latency paths give it
LAT_LANES = (8, 64)
LAT_POOL = 4096
LAT_FLOOR_LANES = 512
LAT_SHAPES = ((8, 4), (8, 8), (8, 16), (8, 32), (64, 8))
# bench_latency's queries; the island path's success on the first 50 of
# them at max_steps 64 (one solve_batch with fused="off": 50 IKSolver.solve
# calls take 2.7–4.4 s each on the card's host, ~200 s), and IKSolver.solve
# itself timed on the first of them
LAT_N = 200
# the wall-clock and device-step deadline rows run on the first
# LAT_DEADLINE_N of them (3 deadlines each; all 200 took ~95 s of the
# smoke's 1 200 s on a slow host)
LAT_DEADLINE_N = 50
LAT_ISLAND_N, LAT_ISLAND_STEPS, LAT_ISLAND_TIMED = 50, 64, 1
# the JAX package's island path on those 50 targets at that budget: 50 of
# 50 on a CPU (tests/test_torch_latency.py::test_island_solve_matches_jax_
# on_bench_latency_targets, which prints it); the port's must be within 0.1
JAX_ISLAND_SUCCESS = 1.0


# the shapes no prebuilt source holds, each on an instance generated and
# built on its first use (kernels/bio2_megastep.megastep_instance,
# bio2_step.species_instance): (kernel row, robot of Smoke.robots, goal
# kinds — instance k on tip k mod T —, secondary terms of its checks).  The
# arm's pose + lookat (7, 2, 1) and the dual arm's two poses + the head's
# lookat (17, 3, 3) are shapes_main's paths (i) and (ii), a lookat alone on
# the 7-DOF arm (the wide layout at (7, 1, 1)) and the humanoid's two hands
# (30, 2, 2) its paths (iv) and (v)
HEAD = "head_tilt_link"
GEN_CASES = (
    ("megastep_7x2x1", "arm", ("pose", "lookat"), ()),
    ("megastep_7x1x1_wide", "arm", ("lookat",), ()),
    ("megastep_17x3x3", "dual_head", ("pose", "pose", "lookat"), REG_TERMS),
    ("megastep_30x2x2", "humanoid_hands", ("pose", "pose"), ()),
)
# the generated species instance: free_arm, PositionGoal + OrientationGoal
# on its tool, (V, K, quaternion mask) = (10, 2, 8)
GEN_SPECIES = ("species_10x2x8", "free_arm.urdf", ("position", "orientation"))
# shapes_main: (i) pr2_arm PositionGoal + LookAtGoal (the JAX package's
# test_engine_solves_lookat, tests/test_kernel.py:527-561) at 1 cm on the
# main path's ladder; (ii) pr2_dual's multigoal problem
# (tests/test_multigoal.py:36-40: both grippers' PoseGoals, the head's
# LookAtGoal at their midpoint, the regularizers at 0.1) at dtwist 1 cm on
# the dual ladder; (iii) free_arm PositionGoal + OrientationGoal on the
# species tier, 5 mm and 5 mrad
B_ARM_LOOK = 65536
B_DUAL_HEAD = 16384
DH_WEIGHT = 0.1
B_FREE_PO = 16384
# the JAX package's fused path (plain jnp on a CPU, each ladder phase its
# own jitted engine solve) on the first 256 of each path's targets at its
# ladder: its success, and each bar (PERF.md §6)
JAX_SHAPES_SUCCESS = {"arm_lookat": 0.3828125, "dual_head": 0.67578125, "free_posori": 1.0}
SHAPES_BARS = {"arm_lookat": 0.995, "dual_head": 0.99, "free_posori": 0.99,
               "arm_lookat_alone": 0.99, "humanoid_two_hands": 0.995}


# the JAX suite's ur5_pose (V = 6: the prebuilt (6, 1, 1) instance of
# csrc/megastep.cu; tools/bench_suite.py:115-121) and kuka_iiwa_pose (V = 7
# with tight bounds on every joint: the bounded-revolute clip path; :168-174)
# through the port's bench_suite (its ROWS) at this batch, each held to
# (success, median position error, megastep launches per solve_batch) —
# 10× the JAX suite's median (BENCHMARKS.md:23-24) as PERF.md §2's rule
B_SUITE = 65536
SUITE_LIMITS = {"ur5_pose": (0.999, 1.8e-6, 4), "kuka_iiwa_pose": (0.999, 9.7e-7, 3)}
# native: the card's float32 FK against the port's float64 C++ oracle on
# this many configurations of each robot, within this tolerance (the JAX
# package's tests/test_native.py:36-46)
NATIVE_N, NATIVE_ATOL = 4096, 3e-6
NATIVE_ROBOTS = (("pr2_arm.urdf", (TIP,)), ("humanoid.urdf", ("r_hand", "l_hand", "head")))
# parallel: the world of two's batch (two ranks over gloo on the one card)
B_WORLD_TWO = 8192
# unfused_modes: the island path's other solvers on the JAX package's own
# quality records (the card's machine has no JAX, so the anchors are
# constants).  Table B (BENCHMARKS.md:157-168): 64 PR2 targets, uniform in
# the bounds from default_rng(42), neutral seeds, steps_per_check =
# max_steps, the solver's default islands (tools/parity_rates.py:89-112);
# rows (name, mode, max_steps, extra config, JAX success and its line).
TABLE_B_N = 64
TABLE_B_ROWS = (
    ("bio1_64", "bio1", 64, {}, 0.563, "BENCHMARKS.md:161"),
    ("bio1_linear_64", "bio1", 64, {"linear_fitness": True}, 0.188, "BENCHMARKS.md:164"),
    ("gd_c_4_float64_256", "gd_c_4", 256, {"dtype": "float64"}, 0.828, "BENCHMARKS.md:165"),
    ("jac_4_32", "jac_4", 32, {}, 0.969, "BENCHMARKS.md:168"),
)
# the JAX suite's two unfused rows (tools/bench_suite.py:155-167: UR5, one
# PoseGoal on tool0, dtwist 1e-3, B = 512 targets uniform in the bounds
# from default_rng(0), a plain IKSolver): (name, mode, max_steps, JAX
# success, JAX median position error in m, their line).  ur5_pose_gd4's
# success bar is vacuous (anchor 0.008), so its median error is held to 3×
# the anchor's.
SUITE_N = 512
SUITE_ROWS = (
    ("ur5_pose_bio1", "bio1", 32, 0.348, 1.3e-3, "BENCHMARKS.md:32"),
    ("ur5_pose_gd4", "gd_4", 64, 0.008, 5.3e-2, "BENCHMARKS.md:33"),
)
# other_modes: the last solver modes on Table B's 64 targets and settings
# (as unfused_modes), at the JAX tests' own step budgets
# (tests/test_solvers.py:203, :306, :329, :338, :357): (mode, max_steps,
# bar).  Bars: "lbfgs" median position error < 2e-2 m; "coarse" < max(½ the
# seeds' median, 2e-2 m); "memetic" < 1e-2 m; "seeds" below the seeds'
# median; "neural2" < 0.5 m.
OTHER_ROWS = (
    ("optlib_lbfgs_4", 16, "lbfgs"), ("optlib_bfgs_4", 16, "lbfgs"),
    ("optlib_lbfgsb_4", 12, "coarse"), ("optlib_gd_4", 12, "coarse"),
    ("optlib_cgd_4", 12, "coarse"), ("optlib_nd_4", 12, "coarse"),
    ("optlib_nm_4", 12, "coarse"), ("optlib_lbfgs_r_4", 16, "lbfgs"),
    ("bio2_memetic_lbfgs", 16, "memetic"), ("neural", 16, "seeds"), ("neural2", 2, "neural2"),
)
OTHER_BARS = {"lbfgs": 2e-2, "coarse": 2e-2, "memetic": 1e-2, "neural2": 0.5}
# a step of these rows is 40 000–200 000 device kernels, whose profile
# takes 6–30 s to gather: each profiles every CUDA graph its solve replayed,
# once, and counts a step as those graphs' kernels times their replays
OTHER_BY_GRAPHS = {"optlib_lbfgs_4", "optlib_bfgs_4", "optlib_lbfgsb_4", "optlib_gd_4",
                   "optlib_lbfgs_r_4", "optlib_nd_4"}
# the JAX package's island path on the first OTHER_N_JAX of those targets
# (tests/test_torch_optlib.py::test_table_b_success_of_the_jax_package,
# which prints it; 15 and 16 of 16); a row's success must reach it less 3
# standard errors of the difference of the two rates
OTHER_N_JAX = 16
JAX_OTHER_SUCCESS = {"optlib_lbfgs_4": 0.9375, "bio2_memetic_lbfgs": 1.0}
# the drot acceptance at small angles: Table B's targets rotated by 1.0 and
# 0.2 mrad about random axes, checked at drot 0.03° (5.24e-4 rad)
DROT_SMALL_DEG = 0.03
# island_kinds: fitness inputs, and the island solve of a PoseGoal beside
# each kind (bio2_memetic, default islands)
KINDS_N = 256
KINDS_B, KINDS_STEPS = 256, 16
WRIST = "r_wrist_roll_link"   # its collision geometry: assets/pr2_gripper_tip.stl


KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by")
# the TPU kernels the megastep and fullstep entries replace (their
# pl.pallas_call)
MEGASTEP_TPU = "bio_ik_tpu/kernels/bio2_megastep.py:321"
FULLSTEP_TPU = "bio_ik_tpu/kernels/bio2_fullstep.py:692"
SPECIES_TPU = "bio_ik_tpu/kernels/bio2_step.py:461"


def _leaves(tree):
    """The tensors of a nested dict/list, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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


def queued_ms(s, keys, data, queue, repeats=REPEATS):
    """Best of ``repeats`` × ``queue`` queued ``s.solve_batch`` calls with
    fresh keys (bench.py's timing): the per-batch times in ms."""
    import torch
    from bio_ik_tpu_torch.engine import fold_in

    times = []
    for _ in range(repeats):
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
        # the robots of this slice's generated instances (GEN_CASES)
        hum_card, hum_cpu, _ = self.robots["humanoid"]
        self.robots["ur5"] = (RobotModel.from_urdf_file(asset_path("ur5.urdf")),
                              RobotModel.from_urdf_file(asset_path("ur5.urdf"), device="cpu"),
                              ("tool0",))
        self.robots.update(arm=(self.model, self.cpu_model, (TIP,)),
                           dual_head=(self.dual, self.dual_cpu, DUAL_TIPS + (HEAD,)),
                           humanoid_hands=(hum_card, hum_cpu, ("r_hand", "l_hand")))
        self.kernels = {name: {} for name in (
            "megastep", "megastep_ur5", "megastep_dual", "megastep_dual_sec", "megastep_snake",
            "megastep_snake_sec", "megastep_humanoid", "megastep_humanoid_sec", "species",
            "fullstep", "fullstep_dual", "fullstep_snake", "fullstep_humanoid", "peak")
            + tuple(c[0] for c in GEN_CASES) + (GEN_SPECIES[0],)}

    # -------------------------------------------------------------- 1 --
    def build(self):
        """Start ``nvcc`` on every source — the prebuilt ones and those
        generated for GEN_CASES' and GEN_SPECIES' shapes — all together in
        a background thread, and return: the phases in KERNEL_FREE run
        while it compiles, and :meth:`build_join` waits for it and reports
        before the first phase that launches a kernel."""
        import threading

        from bio_ik_tpu_torch.kernels.build import build_all

        # the generated instances (their sources resolved, not yet built)
        self.gen = {name: self._wide(1, kinds, terms, robot=robot)[0].source
                    for name, robot, kinds, terms in GEN_CASES}
        self.gen[GEN_SPECIES[0]] = self._species_args(
            GEN_SPECIES[1], 2, dev="cpu", kinds=GEN_SPECIES[2])[0].source
        self.build_t0, self.build_result = time.perf_counter(), {}

        def run():
            try:
                self.build_result["seconds"] = build_all(
                    list(SOURCES) + list(self.gen.values()))
            except BaseException as e:      # re-raised by build_join
                self.build_result["error"] = e

        self.build_thread = threading.Thread(target=run, daemon=True)
        self.build_thread.start()

    def build_join(self):
        """Wait for :meth:`build`'s nvcc runs and report them: card name and
        power limit, versions, each source's nvcc seconds, ptxas reports
        and, per kernel instance, registers, stack and spill; the
        instances' shared memory and resident blocks."""
        import torch
        from bio_ik_tpu_torch.kernels.build import BUILD_SECONDS, ptxas_report, ptxas_table
        from bio_ik_tpu_torch.kernels.checks import HIGH_DOF

        t0 = time.perf_counter()
        self.build_thread.join()
        self.build_thread = None
        if "error" in self.build_result:
            raise self.build_result["error"]
        gen = self.gen
        names = list(SOURCES) + list(gen.values())
        emit({"phase": "build", "gpu": smi_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": self.build_result["seconds"],
              "waited_s": time.perf_counter() - t0, "generated": gen,
              "nvcc_s_by_source": dict(BUILD_SECONDS),
              "ptxas": {n: ptxas_report(n).strip().splitlines()
                        for n in names}})
        for n in names:
            for row in ptxas_table(n):
                emit({"phase": "build", "source": n, **row})
        for name, src in gen.items():
            self.kernels[name].update(generated=src, nvcc_s=BUILD_SECONDS[src])
        # the wide and high-DOF instances: shared memory per block at every
        # G (those the source does not build too) and resident blocks at
        # the G it builds (0: the block does not fit)
        # and the generated ones, each with and without secondary terms; the
        # Python copy of the layout (bio2_megastep.megastep_smem_bytes, which
        # decides the group sizes a generated instance builds) must give the
        # bytes the header's layout() gives
        mismatch = []
        for robot, kinds, terms in [("arm", ("pose",), ()), ("arm", ("pose",), REG_TERMS),
                                    ("dual", POSE2_KINDS, ()), ("dual", MG_KINDS, REG_TERMS)] + [
                (robot, kinds, t) for robot, (_, _, kinds, terms) in HIGH_DOF.items()
                for t in ((), terms)] + [
                (robot, kinds, t) for _, robot, kinds, terms in GEN_CASES
                for t in ((), REG_TERMS)]:
            mega, sp = self._wide(1, kinds, terms, robot=robot)
            lib = mega._lib(2)
            resident = {g: mega.resident_blocks(lib, self.dev, g) for g in mega.groups}
            smem = {g: mega.smem_bytes(lib, g) for g in (1, 2, 4, 8)}
            py = {g: mega.smem_bytes_py(g) for g in (1, 2, 4, 8)}
            if smem != py:
                mismatch.append((robot, kinds, terms, smem, py))
            emit({"phase": "build", "robot": robot,
                  "instance": [sp.V, sp.K, len(self.robots[robot][2])], "inst_kind": kinds,
                  "sec_terms": terms, "source": mega.source,
                  "generated": mega.instance.generated,
                  "dependency_columns": mega.ncol,
                  "smem_bytes_by_group": smem,
                  "resident_blocks_by_group": {g: r or "does not fit"
                                               for g, r in resident.items()},
                  "groups_not_built": [g for g in (1, 2, 4, 8) if g not in mega.groups]})
        if mismatch:
            raise AssertionError(f"the Python layout differs from the header's: {mismatch}")
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
        ``inst_tip[k]`` (default k mod T), every variable active."""
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams

        card, _, tips = self.robots[robot]
        model = model or card
        V, K = model.nvars, len(kinds)
        sp = SpeciesParams(V=V, K=K, C=16, gens=gens, mem_iters=mem_iters,
                           memetic=memetic)
        return Megastep(model, list(tips), list(range(V)),
                        [k % len(tips) for k in range(K)] if inst_tip is None
                        else list(inst_tip), sp, n_steps,
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

    def _wide_check(self, kinds, terms=(), robot="dual", N=N_WIDE_CHECK):
        """A wide or high-DOF megastep (or the narrow one on ``robot``)
        against its plain version (two steps,
        noise tensors, ``N`` lanes) at the group size chosen and,
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

        n = N_WIDE_FLOOR
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
        K, T = len(kinds), len(self.robots[robot][2])
        if K > 1 and T > 1:
            chain = "control_tips_permuted_agree_frac"
            other, _ = self._wide(2, kinds, terms, robot=robot,
                                  inst_tip=[(k + 1) % T for k in range(K)])
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
        self._ur5_check()
        self._wide_fk_check("megastep_dual", POSE2_KINDS)
        row = self._wide_check(POSE2_KINDS)
        emit({"phase": "check", "instance": [17, 2, 2], **row})
        self.kernels["megastep_dual"].update(
            agree_frac=row["agree_frac"], philox_agree_frac=row["philox_agree_frac"],
            floor_agree_frac=row["plain_cpu_vs_card_agree_frac"])
        self._high_checks("check", sec=False)

    def _ur5_check(self):
        """The prebuilt (6, 1, 1) instance (the ur5_pose row's) on UR5's
        tool0, held as the wide instances are, at the lanes of that row's
        first launch: exact FK and fitness with no selection, then lane
        agreement in both randomness modes against its CPU-vs-card floor,
        two wrong plain versions (one joint's axis negated, the rotation
        weights zeroed) and every G bitwise equal to G = 1."""
        from bio_ik_tpu_torch.tools.bench_suite import ROWS

        row = ROWS["ur5_pose"]
        N = phase_shapes(row["phases"], row["fractions"], B_SUITE)[0][0]
        self._wide_fk_check("megastep_ur5", ("pose",), robot="ur5", N=N)
        out = self._wide_check(("pose",), robot="ur5", N=N)
        emit({"phase": "check", "instance": [6, 1, 1], **out})
        if out["reference_group"] != 1:
            raise AssertionError(f"G = 1 of the (6, 1, 1) instance does not fit: {out}")
        self.kernels["megastep_ur5"].update(
            agree_frac=out["agree_frac"], philox_agree_frac=out["philox_agree_frac"],
            floor_agree_frac=out["plain_cpu_vs_card_agree_frac"], group=out["group_chosen"])

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

    def _drive(self, s, data, keys, fk, tg, queue, nlaunch, slots=(0,),
               repeats=EARLIER_REPEATS):
        """One path through ``s.solve_batch``: warm-up, launches of one call
        (counts set to 0 just before it), determinism, best of ``repeats`` × ``queue``
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
        times = queued_ms(s, keys, data, queue, repeats)
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
        _, _, out = self._drive(s, data, keys, fk, tg, QUEUE, len(PHASES), repeats=REPEATS)
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
        t0_ms = queued_ms(s0, k0, d0, REG_QUEUE, EARLIER_REPEATS)
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
    # ------------------------------------------------------------- 5b --
    @staticmethod
    def _single_query_modes(m, tg):
        """``solve``, ``search`` and ``solve_until`` of each bio2 mode (8
        steps, two chunks) and of bio1, gd_4, jac, test, optlib_lbfgs,
        optlib_nm_r_4, bio2_memetic_lbfgs, neural and neural2 (4 steps, one
        chunk: a bio1 step takes ~0.3 s on the card's host; the neural
        modes trained 200 steps) on the card, the first target, and
        ``elite_migration`` on the island path: every result finite."""
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, SolverConfig
        from bio_ik_tpu_torch.tools import bench_latency as bl

        seed = m.neutral_q()
        rows = {}
        for mode, migrate in (("bio2", False), ("bio2_memetic", False),
                              ("bio2_memetic_l", False), ("bio2_memetic", True),
                              ("bio1", False), ("gd_4", False), ("jac", False),
                              ("test", False), ("optlib_lbfgs", False),
                              ("optlib_nm_r_4", False), ("bio2_memetic_lbfgs", False),
                              ("neural", False), ("neural2", False)):
            fused = mode in ("bio2", "bio2_memetic", "bio2_memetic_l")
            s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
                mode=mode, dtwist=1e-3, max_steps=8 if fused else 4,
                steps_per_check=4, elite_migration=migrate, neural_train_steps=200))
            d = bl._query(s.make_data(seed), tg, 0)
            res = [s.solve(seed, key=[0, 5], data=d),
                   s.search(seed, key=[0, 5], data=d, return_approximate_solution=True),
                   s.solve_until(seed, key=[0, 5], data=d)]
            rows[mode + ("+elite_migration" if migrate else "")] = {
                "engine": s.engine is not None,
                "success": [bool(r.success) for r in res],
                "finite": all(bool(torch.isfinite(r.q).all()) for r in res)}
        bad = {k: v for k, v in rows.items() if not v["finite"]}
        if bad:
            raise AssertionError(f"single-query entry points: {bad}")
        return rows

    def latency_check(self):
        """The narrow megastep at latency mode's launch shapes (one query:
        LAT_LANES lanes a launch, the group size the wrapper chooses) against
        its plain version in Philox mode, pooled over LAT_POOL lanes of
        repeated launches, each with its own salt as each query has (the
        plain version run on the pooled lanes with each column's lane index
        of its launch): agreement against min(0.85, floor − 0.03), the floor
        being the plain version on the CPU against the card on the first
        LAT_FLOOR_LANES lanes; every launch bitwise equal to G = 1.  Then
        the kernel's time at each of LAT_SHAPES beside its bounds, and the
        plain version's at the first."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import philox_draw

        mega, sp = self._mega(2)
        cpu_mega, _ = self._mega(2, model=self.cpu_model)
        seed = 0x2468ACE
        rows = []
        for M in LAT_LANES:
            state, consts, _ = self._inputs(sp, 2, LAT_POOL, with_noise=False, seed=13)
            gen = torch.Generator(self.dev).manual_seed(M)
            L = LAT_POOL // M
            salt = torch.randint(-2**31, 2**31 - 1, (L,), dtype=torch.int32, device=self.dev,
                                 generator=gen).repeat_interleave(M)[None].contiguous()
            lane = (torch.arange(LAT_POOL, device=self.dev) % M)[None]
            outs, bitwise = [], []
            for j in range(L):
                cols = slice(j * M, (j + 1) * M)
                st, cs = (tuple(t[:, cols].contiguous() for t in x) for x in (state, consts))
                sj = salt[:, cols].contiguous()
                k = mega(st, cs, seed=seed, salt=sj)
                k1 = mega(st, cs, seed=seed, salt=sj, group=1)
                bitwise.append(all(torch.equal(a, b) for a, b in zip(k, k1)))
                outs.append(k)
            k_out = tuple(torch.cat([o[i] for o in outs], 1) for i in range(len(outs[0])))
            p_out = mega.body(state, consts, philox_draw(seed, salt, sp.V, sp.C, lane=lane))
            n = LAT_FLOOR_LANES
            cut = lambda xs: tuple(x[:, :n].cpu() for x in xs)  # noqa: E731
            c_out = cpu_mega.body(cut(state), cut(consts),
                                  philox_draw(seed, salt[:, :n].cpu(), sp.V, sp.C,
                                              lane=lane[:, :n].cpu()))
            torch.cuda.synchronize()
            row = {"lanes_per_launch": M, "launches": L, "pooled_lanes": LAT_POOL,
                   "group_chosen": mega.group(mega._lib(M), self.dev, M),
                   "agree_frac": agree_frac(k_out, p_out),
                   "plain_cpu_vs_card_agree_frac": agree_frac(c_out, cut(p_out)),
                   "bitwise_vs_g1_frac": sum(bitwise) / L}
            row["agree_limit"] = min(0.85, row["plain_cpu_vs_card_agree_frac"] - 0.03)
            rows.append(row)
        times = self._mega_rows(LAT_SHAPES)
        N, steps = LAT_SHAPES[0]
        pm, psp = self._mega(steps)
        state, consts, _ = self._inputs(psp, steps, N, with_noise=False)
        salt = torch.zeros((1, N), dtype=torch.int32, device=self.dev)
        plain_ms = cuda_ms(lambda: pm.body(state, consts, philox_draw(99, salt, psp.V, psp.C)), 1)
        emit({"phase": "latency_check", "agreement": rows, "megastep": times,
              "plain_ms_at_first_shape": plain_ms, "gpu": smi_line()})
        self.kernels["megastep"].update(
            latency_agree_frac=min(r["agree_frac"] for r in rows),
            latency_group=[r["group_chosen"] for r in rows],
            latency_ms={f"{r['lanes']}x{r['n_steps']}": r["ms"] for r in times},
            latency_bound_ms={f"{r['lanes']}x{r['n_steps']}": r["bound_ms"] for r in times},
            latency_plain_ms=plain_ms)
        for r in rows:
            if r["agree_frac"] < r["agree_limit"]:
                raise AssertionError(f"the megastep at {r['lanes_per_launch']} lanes agrees "
                                     f"with its plain version below its limit: {r}")
            if r["bitwise_vs_g1_frac"] < 1.0:
                raise AssertionError(f"a group size changes the result: {r}")

    def latency(self):
        """Latency mode and the single-query entry points on the card through
        ``bio_ik_tpu_torch.tools.bench_latency`` (PR2, PoseGoal, dtwist 1e-3,
        LAT_N targets): ``IKSolver.solve_until`` at each (steps_per_check,
        64) — success ≥ 0.995 and one megastep launch per chunk run —;
        ``solve_batch`` at B = 1; the wall-clock deadlines and the device-step
        budgets of the deadlines at islands = 32, both on the first
        LAT_DEADLINE_N targets (the 20 ms budget's success ≥ 0.99); the island path's success on the first LAT_ISLAND_N targets
        (within 0.1 of the JAX package's ``solve``) and ``IKSolver.solve``'s
        time per query on the first LAT_ISLAND_TIMED; a query split into
        prep, kernel and glue, with the synchronizing host copies of its prep
        counted and none allowed in a chunk (``torch.cuda`` sync debug mode);
        the device's idle share over one query of each path.  Launch counts
        from 0 just before each path, read just after."""
        import warnings

        import torch
        from bio_ik_tpu_torch.interop import tree_map
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.tools import bench_latency as bl

        m, _, tg = bl.setup("cuda", n=LAT_N)
        out = {"phase": "latency", "gpu": smi_line(), "n": LAT_N}
        Megastep.launches = 0
        out["solve_until"] = [bl.run_setting(m, tg, spc, ms) for spc, ms in bl.SETTINGS]
        out["solve_until_launches"] = launches = Megastep.launches
        out["fused_single_dispatch"] = bl.run_fused_single(m, tg)
        out["deadline_wall"] = [bl.run_deadline(m, tg, t, n=LAT_DEADLINE_N)
                                for t in bl.DEADLINES_S]
        out["deadline_device"] = bl.run_deadline_device(m, tg, n=LAT_DEADLINE_N)
        out["breakdown"] = bl.run_breakdown(m, tg, n=50)
        # the prep's synchronizing copies, and none inside a chunk
        s = bl._solver(m, max_steps=64, steps_per_check=4)
        key = torch.tensor([0, 1], device=self.dev)
        q1 = bl._query(s.make_data(m.neutral_q()), tg, 1)
        s.solve_until(m.neutral_q(), key=key, data=q1)          # warm-up
        d = tree_map(lambda x: x[None], q1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, consts, salt, best = s.engine._mega_prep(key[None], d)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out["prep_synchronizing_ops"] = sum("synchroniz" in str(w.message) for w in caught)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c in range(4):
                state, best = s.engine._mega_chunk(c, salt, state, consts, best, d)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out["chunk_synchronizing_ops"] = 0
        out["modes"] = self._single_query_modes(m, tg)
        Megastep.launches = 0
        out["island_solve"] = bl.run_island(m, tg, n=LAT_ISLAND_TIMED,
                                            max_steps=LAT_ISLAND_STEPS)
        out["island_batch"] = bl.run_island_batch(m, tg, n=LAT_ISLAND_N,
                                                  max_steps=LAT_ISLAND_STEPS)
        out["island_megastep_launches"] = Megastep.launches
        out["jax_island_success_rate_cpu"] = JAX_ISLAND_SUCCESS
        # the device's idle share over one query: solve_until, and the
        # island path at 4 steps (its share per step; a 64-step query takes
        # seconds)
        data1 = bl._query(s.make_data(m.neutral_q()), tg, 3)
        si = bl._solver(m, max_steps=4)
        out["profile_solve_until"] = self._profile_call(
            lambda: s.solve_until(m.neutral_q(), key=key, data=data1))
        out["profile_island_solve_4_steps"] = self._profile_call(
            lambda: si.solve(m.neutral_q(), key=key, data=data1))
        for k in ("profile_solve_until", "profile_island_solve_4_steps"):
            out[k].pop("top")
        emit(out)
        self.kernels["megastep"]["latency_launches"] = launches
        bad = [r for r in out["solve_until"] if r["success_rate"] < 0.995
               or r["megastep_launches_per_query"] != r["chunks_per_query"]]
        if bad or launches == 0:
            raise AssertionError(f"solve_until below 0.995, or not one megastep launch "
                                 f"per chunk: {bad}, {launches} launches")
        if out["deadline_device"][-1]["success_at_deadline"] < 0.99:
            raise AssertionError(f"the 20 ms device budget solves below 0.99: "
                                 f"{out['deadline_device']}")
        if out["island_megastep_launches"]:
            raise AssertionError("the island path launched the megastep")
        isl = out["island_batch"]["success_rate"]
        if abs(isl - JAX_ISLAND_SUCCESS) > 0.1:
            raise AssertionError(f"the island path's success {isl} is not within 0.1 of "
                                 f"the JAX package's {JAX_ISLAND_SUCCESS}")

    def _species_args(self, urdf, N, gens=8, mem_iters=8, memetic="q", dev=None,
                      sec_terms=(), philox=False, kinds=("pose",)):
        """A SpeciesKernel of the robot's species path and one step's
        arguments on ``N`` lanes (kernels/checks.species_inputs; a goal
        instance of each of ``kinds`` on the tool): the noise-tensor
        arguments, or with ``philox`` ``(args, kw)`` for the in-kernel
        Philox mode (``kw``: salt, sec)."""
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel, SpeciesParams
        from bio_ik_tpu_torch.kernels.checks import species_inputs

        qs = dict((u, q) for u, _, q in SPECIES_PATHS)[urdf]
        model = self.sp_cpu_models[urdf]
        sp = SpeciesParams(V=model.nvars, K=len(kinds), gens=gens, mem_iters=mem_iters,
                           memetic=memetic, quat_slices=qs)
        args = species_inputs(model, "tool", sp, N, sec_terms=sec_terms, philox=philox,
                              inst_kind=list(kinds))
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
        modes: free_arm, planar_arm and the secondary-goal instance (the
        regularizers' terms, free_arm) at each path's launch lanes (524 288,
        131 072, 131 072) — bitwise under CLT4 and with noise tensors; Box–Muller
        (logf/cosf) by lane agreement (≥ 0.999, just under the floor of the
        plain version on the CPU against itself on the card: 0.99994 on an
        H100) beside that floor; the noise-tensor
        floor and agreement by stage as before."""
        import torch
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        out = {"phase": "species_check"}
        shapes = [(urdf, B * SPECIES_ISLANDS * 2, ())
                  for urdf, B, _ in SPECIES_PATHS] + [
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
    def _species_bench(self, urdf, B, regularized=False, orientation=False):
        """The JAX suite's floating-base row on ``urdf`` at batch ``B``
        (with ``regularized``, plus MinimalDisplacementGoal and
        AvoidJointLimitsGoal of weight 0.05; with ``orientation``, plus an
        OrientationGoal on the tool within 5 mrad — shapes_main's path
        (iii)): targets from FK of numpy.random.default_rng(0) uniform draws
        in the bounds, seeded at neutral_q()."""
        import math

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
        if orientation:
            goals.append(G.OrientationGoal(link="tool"))
        if regularized:
            goals += [G.MinimalDisplacementGoal(weight=REG_WEIGHT),
                      G.AvoidJointLimitsGoal(weight=REG_WEIGHT)]
        s = IKSolver(model, goals,
                     SolverConfig(mode="bio2_memetic", dpos=5e-3,
                                  drot=math.degrees(5e-3) if orientation else float("inf"),
                                  dtwist=float("inf"), max_steps=16,
                                  islands=SPECIES_ISLANDS))
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(model.neutral_q())))
        data["primary"][0]["position"] = tg.pos.contiguous()
        if orientation:
            data["primary"][1]["orientation"] = tg.quat.contiguous()
        keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                            torch.arange(B, dtype=torch.int64)], -1).to(dev)
        return s, data, keys, fk, tg

    def _species_drive(self, urdf, B, regularized=False, orientation=False,
                       bar=0.999, repeats=EARLIER_REPEATS):
        """One species-tier path through IKSolver.solve_batch: the fields of
        :meth:`_drive` for the species kernel, the share of unit floating
        quaternions and the peak memory (with ``orientation``, shapes_main's
        path (iii), also the median orientation error; success ≥ ``bar``)."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel
        from bio_ik_tpu_torch.math.quat import quat_angle_shortest
        from bio_ik_tpu_torch.robot.urdf import FLOATING

        s, data, keys, fk, tg = self._species_bench(urdf, B, regularized, orientation)
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
        times = queued_ms(s, keys, data, SPECIES_QUEUE, repeats)
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
        if orientation:
            out["instance_source"] = s.engine.kernel.source
            out["median_rot_err_rad"] = float(quat_angle_shortest(
                fk(res.q).quat[:, 0], tg.quat[:, 0]).median())
            out["device_idle_share"] = self._profile(s, data, keys)["device_idle_share"]
        fail = None
        if launches != 16:
            fail = f"{launches} species launches per solve_batch"
        elif not det:
            fail = "two runs with the same keys differ"
        elif flags_agree < 0.999:
            fail = "success flags disagree with a re-check"
        elif not (success >= bar and med <= 5e-4 and np.isfinite(med)):
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
        out["pose_only_batch_time_ms"] = min(queued_ms(s0, k0, d0, SPECIES_QUEUE,
                                                       EARLIER_REPEATS))
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
    # -------------------------------------------------------- unfused --
    @staticmethod
    def _kernel_counts():
        from bio_ik_tpu_torch.kernels.bio2_megastep import Fullstep, Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel

        return (Megastep, Fullstep, SpeciesKernel)

    def _unfused_row(self, m, tip, tg, cfg, name, anchor, src, solver=None, by_graphs=False):
        """One ``IKSolver.solve_batch`` of a PoseGoal on each of ``tg``'s
        targets (neutral seeds) on the island path: success, median and
        90th-percentile position error, ms per step (wall clock, the card
        synchronized); then one solver step of the same rows under the
        profiler (the island path's ``Solver.step`` on every scenario ×
        island row, after an ``init`` and a warm-up step): its kernel
        launches and the device's idle share of its wall time — a profiled
        solve would add its init, winner and result, and torch.profiler
        takes ~1 s to gather each ~4 000 device events.  The hand-written
        kernels' counts, set to 0 just before the timed solve, must read 0
        after it: the island path launches none.  ``solver``: the
        ``IKSolver`` of ``cfg``, built by the caller; ``anchor`` None: no
        JAX record (no success bar).  The CUDA graph replays of the timed
        solve (graphs.Replay) are counted; ``by_graphs``: in place of a
        step, each graph the solve replayed is profiled once, and a step's
        launches and device time are its graphs' kernels times their
        replays — the eager kernels between replays are not counted, so the
        launches are a lower bound and the idle share an upper one."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, make_fk
        from bio_ik_tpu_torch.graphs import Replay
        from bio_ik_tpu_torch.interop import tree_map
        from bio_ik_tpu_torch.math.quat import quat_angle_shortest

        B = tg.pos.shape[0]
        s = solver or IKSolver(m, [G.PoseGoal(link=tip)], cfg)
        if s.engine is not None or "not a fused bio2 family" not in s.unsupported:
            raise AssertionError(f"{name}: not on the island path ({s.unsupported})")
        dt = s.problem.tdtype
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(m.neutral_q(), device=self.dev)))
        data["primary"][0]["position"] = tg.pos.to(dt).contiguous()
        data["primary"][0]["orientation"] = tg.quat.to(dt).contiguous()
        keys = torch.stack([torch.full((B,), 7), torch.arange(B)], -1).to(self.dev)
        kinds = self._kernel_counts()
        for k in kinds:
            k.launches = 0
        Replay.replays = 0
        replays_of = [r for r in vars(s.solver).values() if isinstance(r, Replay)]
        for r in replays_of:
            r.counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s.solve_batch(keys, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel_launches = {k.__name__: k.launches for k in kinds}
        replays = Replay.replays
        fk = make_fk(m, [tip])
        got = fk(res.q)
        err = (got.pos - tg.pos.to(res.q.dtype))[:, 0].norm(dim=-1).cpu().numpy()
        rot = quat_angle_shortest(got.quat, tg.quat.to(res.q.dtype))[:, 0].cpu().numpy()
        t1 = time.perf_counter()
        if by_graphs:
            # each graph's first replay was in the solve: no warm-up
            prof = [(self._profile_call(g.replay, warm=False), n)
                    for r in replays_of for g, n in r.graphs() if n]
            step = {"device_launches": sum(p["device_launches"] * n for p, n in prof)
                    / cfg.max_steps,
                    "device_busy_ms": sum(p["device_busy_ms"] * n for p, n in prof)
                    / cfg.max_steps,
                    "graphs_profiled": len(prof)}
            step["device_idle_share"] = 1.0 - step["device_busy_ms"] / (
                wall * 1e3 / cfg.max_steps)
        else:
            state, _, data_r = s._init_islands(keys, data)
            state = s.solver.step(state, data_r)
            step = self._profile_call(lambda: s.solver.step(state, data_r), warm=False)
        profile_s = time.perf_counter() - t1
        n = B
        se = None if anchor is None else float(np.sqrt(anchor * (1 - anchor) / n))
        return {"row": name, "mode": cfg.mode, "dtype": str(res.q.dtype).split(".")[-1],
                "islands": s.islands, "max_steps": cfg.max_steps, "n": n,
                "success_rate": float(res.success.float().mean()),
                "median_pos_err_m": float(np.median(err)),
                "p90_pos_err_m": float(np.percentile(err, 90)),
                "median_rot_err_rad": float(np.median(rot)),
                "p90_rot_err_rad": float(np.percentile(rot, 90)),
                "ms_per_step": wall * 1e3 / cfg.max_steps, "solve_batch_ms": wall * 1e3,
                "graph_replays_per_step": replays / cfg.max_steps,
                "profiled": "graphs" if by_graphs else "step",
                "launches_per_step": step["device_launches"],
                "device_idle_share": step["device_idle_share"],
                **({"graphs_profiled": step["graphs_profiled"],
                    "device_busy_ms_per_step": step["device_busy_ms"]} if by_graphs else
                   {"profiled_ms_per_step": step["wall_ms"]}),
                "kernel_launches": kernel_launches, "profile_seconds": profile_s,
                "jax_success": anchor, "jax_source": src,
                "success_bar": None if anchor is None else anchor - 3 * se,
                "box_violation": self._box_violation(s, res.qa),
                **({"iterate_box_violation": self._iterate_box_violation(s, keys, data)}
                   if cfg.mode in ("optlib_lbfgsb_4", "optlib_lbfgs_4") else {})}

    @staticmethod
    def _box_violation(s, qa):
        import torch
        p = s.problem
        return float(torch.clamp(torch.maximum(p.aclip_min - qa, qa - p.aclip_max),
                                 min=0).max())

    def _iterate_box_violation(self, s, keys, data):
        """The largest violation of the box by the iterates of one optlib
        step's inner updates from the solve's init, before the step's final
        clip: lbfgsb projects each, lbfgs does not."""
        from bio_ik_tpu_torch.solvers.optlib import _INNER_UPDATES

        st, _, d = s._init_islands(keys, data)
        ev, qa, o, worst = s.solver._evaluators(d), st.qa, st.opt_state, 0.0
        for _ in range(_INNER_UPDATES):
            qa, o = s.solver._inner_optax(ev, qa, o)
            worst = max(worst, self._box_violation(s, qa))
        return worst

    def unfused_modes(self):
        """The island path's other solvers on the card through
        ``IKSolver.solve_batch`` (item 5b), on the JAX package's records:
        Table B's 64 PR2 targets (TABLE_B_ROWS: bio1, bio1 with
        linear_fitness, gd_c_4 in float64, jac_4) and the suite's UR5 rows
        at B = 512 (SUITE_ROWS); each row's success ≥ its JAX anchor − 3·SE
        (SE = √(p(1−p)/n)), ur5_pose_gd4's median position error ≤ 3× its
        anchor; bio1's rotation distance 0.5 mrad from the Table B targets
        within 2e-5 rad; and a ``test``-mode solve whose linearizer errors
        are finite and below 1e-2 m and 1e-2 rad."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
        from bio_ik_tpu_torch.interop import tree_map

        out = {"phase": "unfused_modes", "gpu": smi_line(), "rows": []}
        m = self.model
        b = m._np_bounds
        qg = np.random.default_rng(42).uniform(b["min"], b["max"], (TABLE_B_N, m.nvars))
        tg = tg_b = make_fk(m, [TIP])(torch.as_tensor(qg.astype(np.float32),
                                                      device=self.dev))
        for name, mode, steps, extra, anchor, src in TABLE_B_ROWS:
            cfg = SolverConfig(mode=mode, dtwist=1e-3, max_steps=steps,
                               steps_per_check=steps, **extra)
            out["rows"].append(self._unfused_row(m, TIP, tg, cfg, name, anchor, src))
        ur5 = RobotModel.from_urdf_file(asset_path("ur5.urdf"))
        b = ur5._np_bounds
        qg = np.random.default_rng(0).uniform(b["min"], b["max"], (SUITE_N, ur5.nvars))
        tg = make_fk(ur5, ["tool0"])(torch.as_tensor(qg.astype(np.float32), device=self.dev))
        for name, mode, steps, anchor, err_anchor, src in SUITE_ROWS:
            row = self._unfused_row(ur5, "tool0", tg, SolverConfig(
                mode=mode, dtwist=1e-3, max_steps=steps), name, anchor, src)
            row["jax_median_pos_err_m"] = err_anchor
            out["rows"].append(row)

        # bio1's rotation distance on the card 0.5 mrad from Table B's
        # targets, whose FK quaternions' norms exceed 1 by ~1e-7 here: the
        # JAX package's clamped arccos reads most of them as 0
        from bio_ik_tpu_torch.math.frame import Frame
        from bio_ik_tpu_torch.math.quat import (quat_angle_shortest, quat_from_axis_angle,
                                                quat_mul)

        sb = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(mode="bio1", dtwist=1e-3,
                                                             linear_fitness=True))
        d = tree_map(lambda x: x.expand((TABLE_B_N,) + x.shape).contiguous(),
                     sb.make_data(torch.as_tensor(m.neutral_q(), device=self.dev)))
        d["primary"][0]["position"], d["primary"][0]["orientation"] = tg_b.pos, tg_b.quat
        axis = torch.as_tensor(np.random.default_rng(9).normal(size=(TABLE_B_N, 3)),
                               dtype=torch.float32, device=self.dev)
        axis = axis / axis.norm(dim=-1, keepdim=True)
        theta = torch.full((TABLE_B_N,), 5e-4, device=self.dev)
        tq = quat_mul(tg_b.quat[:, 0], quat_from_axis_angle(axis, theta))[:, None]
        rot = sb.solver._distances(Frame(tg_b.pos, tq), d)[1][:, 0]
        out["bio1_small_angle"] = {
            "angle_rad": 5e-4, "max_abs_err_rad": float((rot - theta).abs().max()),
            "arccos_zero_frac": float((quat_angle_shortest(tq, tg_b.quat)[:, 0] == 0)
                                      .float().mean())}

        # test mode: the linearizer against exact FK about the seed
        s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(mode="test", max_steps=1))
        d = tree_map(lambda x: x[None], s.make_data(torch.as_tensor(m.neutral_q(),
                                                                    device=self.dev)))
        st, _, _ = s._init_islands(torch.tensor([[0, 3]], device=self.dev), d)
        res = s.solve(m.neutral_q())
        out["test_mode"] = {"pos_err_m": float(st.pos_err[0]), "rot_err_rad": float(st.rot_err[0]),
                            "solve_finite": bool(torch.isfinite(res.q).all())}
        emit(out)
        bad = []
        for r in out["rows"]:
            if r["row"] == "ur5_pose_gd4":
                ok = r["median_pos_err_m"] <= 3 * r["jax_median_pos_err_m"]
            else:
                ok = r["success_rate"] >= r["success_bar"]
            if not ok or any(r["kernel_launches"].values()) or not np.isfinite(
                    r["median_pos_err_m"]):
                bad.append(r["row"])
        tm = out["test_mode"]
        if not (tm["solve_finite"] and 0 < tm["pos_err_m"] < 1e-2
                and 0 < tm["rot_err_rad"] < 1e-2):
            bad.append("test")
        if not out["bio1_small_angle"]["max_abs_err_rad"] <= 2e-5:
            bad.append("bio1_small_angle")
        if bad:
            raise AssertionError(f"unfused modes below their bars: {bad}")

    def other_modes(self):
        """The last solver modes on the card through ``IKSolver.solve_batch``
        (the optlib family, bio2_memetic_lbfgs, neural, neural2) on Table
        B's 64 PR2 targets and settings (OTHER_ROWS): success, median and
        p90 position error, ms and launches per step and the device's idle
        share (:meth:`_unfused_row`), neural's training seconds and final
        loss, the largest violation of the box by lbfgsb's inner iterates
        before the step's final clip (and by lbfgs's, which are not
        projected); each row held to its
        bar (OTHER_BARS, against the seeds' median error) and, where the
        JAX package's success on the first 16 targets is recorded
        (JAX_OTHER_SUCCESS), to it less 3 standard errors.  Then the drot
        acceptance at 0.03° on the targets rotated by 1.0 mrad (every one
        rejected) and by 0.2 mrad (every one accepted)."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, SolverConfig, make_fk
        from bio_ik_tpu_torch.interop import tree_map
        from bio_ik_tpu_torch.math.frame import Frame
        from bio_ik_tpu_torch.math.quat import (quat_angle_shortest, quat_from_axis_angle,
                                                quat_mul)

        out = {"phase": "other_modes", "gpu": smi_line(), "rows": []}
        m = self.model
        b = m._np_bounds
        qg = np.random.default_rng(42).uniform(b["min"], b["max"], (TABLE_B_N, m.nvars))
        fk = make_fk(m, [TIP])
        tg = fk(torch.as_tensor(qg.astype(np.float32), device=self.dev))
        seed_err = (fk(torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                       device=self.dev)).pos
                    - tg.pos)[:, 0].norm(dim=-1)
        out["seeds_median_pos_err_m"] = seed_med = float(seed_err.median())
        bad = []
        for name, steps, bar in OTHER_ROWS:
            cfg = SolverConfig(mode=name, dtwist=1e-3, max_steps=steps,
                               steps_per_check=steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = IKSolver(m, [G.PoseGoal(link=TIP)], cfg)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            anchor = JAX_OTHER_SUCCESS.get(name)
            row = self._unfused_row(
                m, TIP, tg, cfg, name, anchor,
                None if anchor is None else
                "tests/test_torch_optlib.py::test_table_b_success_of_the_jax_package",
                solver=s, by_graphs=name in OTHER_BY_GRAPHS)
            if anchor is not None:
                # the SE of the difference of the two rates, the JAX rate of
                # 16 targets taken with one success and one failure added
                # (Agresti–Caffo): at 16 of 16 the plain estimate is 0
                pj = (anchor * OTHER_N_JAX + 1) / (OTHER_N_JAX + 2)
                se = np.sqrt(pj * (1 - pj) * (1 / OTHER_N_JAX + 1 / TABLE_B_N))
                row["success_bar"] = anchor - 3 * se
            if name.startswith("neural"):
                row.update(train_seconds=build_s,
                           train_steps=cfg.neural_train_steps,
                           final_loss=float(s.solver.final_loss))
            med = row["median_pos_err_m"]
            limit = {"lbfgs": OTHER_BARS["lbfgs"], "memetic": OTHER_BARS["memetic"],
                     "neural2": OTHER_BARS["neural2"], "seeds": seed_med,
                     "coarse": max(0.5 * seed_med, OTHER_BARS["coarse"])}[bar]
            row["median_bar_m"] = limit
            ok = np.isfinite(med) and med < limit and not any(
                row["kernel_launches"].values())
            if row["success_bar"] is not None:
                ok &= row["success_rate"] >= row["success_bar"]
            if name == "optlib_lbfgsb_4":
                ok &= row["iterate_box_violation"] <= 1e-6
            if not ok:
                bad.append(name)
            out["rows"].append(row)

        # drot at 0.03°: the rows 1.0 and 0.2 mrad off Table B's targets
        s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
            drot=DROT_SMALL_DEG, dtwist=float("inf")))
        n = TABLE_B_N
        d = tree_map(lambda x: x.expand((2 * n,) + x.shape).contiguous(),
                     s.make_data(torch.as_tensor(m.neutral_q(), device=self.dev)))
        d["primary"][0]["position"] = torch.cat([tg.pos, tg.pos])
        d["primary"][0]["orientation"] = torch.cat([tg.quat, tg.quat])
        axis = torch.as_tensor(np.random.default_rng(9).normal(size=(2 * n, 3)),
                               dtype=torch.float32, device=self.dev)
        axis = axis / axis.norm(dim=-1, keepdim=True)
        theta = torch.cat([torch.full((n,), 1.0e-3), torch.full((n,), 0.2e-3)]).to(self.dev)
        gq = torch.cat([tg.quat, tg.quat])[:, 0]
        tq = quat_mul(gq, quat_from_axis_angle(axis, theta))[:, None]
        ok = s.problem.check_solution(Frame(d["primary"][0]["position"], tq),
                                      d["seed_active"], d)
        arccos_ok = (quat_angle_shortest(tq, gq[:, None])[:, 0] * (180 / np.pi)
                     <= DROT_SMALL_DEG)
        out["drot_small_angle"] = {
            "drot_deg": DROT_SMALL_DEG,
            "rejected_1mrad": float((~ok[:n]).float().mean()),
            "accepted_0p2mrad": float(ok[n:].float().mean()),
            "arccos_would_accept_1mrad": float(arccos_ok[:n].float().mean()),
            "arccos_would_accept_0p2mrad": float(arccos_ok[n:].float().mean()),
            "goal_norm_sq_minus_1_mean": float(((gq * gq).sum(-1) - 1).mean())}
        emit(out)
        ds = out["drot_small_angle"]
        if not (ds["rejected_1mrad"] == 1.0 and ds["accepted_0p2mrad"] == 1.0):
            bad.append("drot_small_angle")
        if bad:
            raise AssertionError(f"other modes below their bars: {bad}")

    def island_kinds(self):
        """The four goal kinds only the island path evaluates (item 5d) on the
        card: each kind's fitness at KINDS_N configurations against the
        port's plain path on the CPU on the same tip frames, within 1e-5
        relative beside 1e-9 absolute (touch on the fingertip mesh and on
        the tool frame's box, balance on the PR2 arm's inertials, the
        function goals written in torch); an island ``solve_batch``
        (bio2_memetic, B = KINDS_B, KINDS_STEPS steps) of a PoseGoal beside
        each kind, the touch planes and the balance target placed where the
        target configuration meets them, its fitness below a tenth of the
        seed's; ``counter=True`` on ``solve_until`` (fused and island
        branches: the recorded steps equal ``last_steps``); and
        ``params.solver_from_spec`` building the hand-built problem leaf for
        leaf (item 6)."""
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import IKSolver, Problem, SolverConfig, make_fk, params
        from bio_ik_tpu_torch.interop import tree_map
        from bio_ik_tpu_torch.math.quat import quat_rotate
        from bio_ik_tpu_torch.problem import _EVALUATORS

        m, mc = self.model, self.cpu_model

        def floor_fn(p, q):
            # keep the tool frame above the table plane z = 0.2
            return torch.clamp(p[..., 2] - 0.2, max=0.0) ** 2 + 0.0 * q[..., 3]

        def range_fn(v):
            # prefer the shoulder pan and the elbow flex inside [-1, 0.3]
            return torch.clamp(v, -1.0, 0.3)

        def kinds():
            return {
                "touch_mesh": G.TouchGoal(link=WRIST, position=(0.0, 0.0, 0.2),
                                          normal=(0.0, 0.0, 1.0), weight=0.5),
                "touch_box": G.TouchGoal(link=TIP, position=(0.0, 0.0, 0.2),
                                         normal=(0.0, 0.0, 1.0), weight=0.5),
                "balance": G.BalanceGoal(target=(0.1, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
                                         weight=0.5),
                "link_function": G.LinkFunctionGoal(link=TIP, function=floor_fn),
                "joint_function": G.JointFunctionGoal(
                    variable_names=("r_shoulder_pan_joint", "r_elbow_flex_joint"),
                    function=range_fn, weight=0.5)}

        out = {"phase": "island_kinds", "gpu": smi_line(), "fitness": {}, "solve": {}}
        b = m._np_bounds
        rng = np.random.default_rng(5)
        qs = rng.uniform(b["min"], b["max"], (KINDS_N, m.nvars)).astype(np.float32)
        bad = []
        # the tip frames from the CPU's FK, the same inputs on both sides
        tips_cpu = {}
        for name, goal in kinds().items():
            vals = []
            for model, dev in ((mc, "cpu"), (m, self.dev)):
                p = Problem(model, [G.PoseGoal(link=TIP), goal],
                            config=SolverConfig(dtwist=1e-3))
                if name not in tips_cpu:
                    t = make_fk(model, p.tip_links)(torch.as_tensor(qs))
                    tips_cpu[name] = torch.cat([t.pos, t.quat], -1)
                q = torch.as_tensor(qs, device=dev)
                packed = tips_cpu[name].to(dev)
                d = p.make_data(torch.as_tensor(model.neutral_q(), device=dev))
                grp, gdata = p.primary[1], d["primary"][1]
                e = _EVALUATORS[grp.kind](p, grp, gdata, packed, q, d)
                vals.append((gdata["weight_sq"] * e).sum(-1).double().cpu().numpy())
            cpu, card = vals
            err = np.abs(card - cpu)
            # 1e-5 relative; beside it 1e-9 (m², rad²) absolute: a squared
            # distance d² moves by 2·d·ε under the float32 rounding ε ~ 1e-7
            # of O(1 m) terms (FMA contraction on the card), which exceeds
            # 1e-5·d² for d below 2 cm
            ok = bool(np.all(err <= 1e-5 * np.abs(cpu) + 1e-9))
            out["fitness"][name] = {
                "max_abs_err": float(err.max()),
                "max_rel_err": float(np.max(err / np.maximum(np.abs(cpu), 1e-30))),
                "max_rel_err_above_1e-4": float(np.max(np.where(
                    np.abs(cpu) >= 1e-4, err / np.maximum(np.abs(cpu), 1e-30), 0.0))),
                "nonzero_frac": float((cpu > 0).mean()), "within_limit": ok}
            if not ok or not (cpu > 0).any():
                bad.append(f"fitness {name}")

        # an island solve of a PoseGoal beside each kind: targets at FK of q*,
        # the touch planes and the balance target per scenario at q*
        B = KINDS_B
        qt = rng.uniform(b["min"] * 0.5, b["max"] * 0.5, (B, m.nvars)).astype(np.float32)
        qt = torch.as_tensor(qt, device=self.dev)
        for name, goal in kinds().items():
            s = IKSolver(m, [G.PoseGoal(link=TIP), goal], SolverConfig(
                mode="bio2_memetic", dtwist=1e-3, max_steps=KINDS_STEPS,
                steps_per_check=KINDS_STEPS))
            if s.engine is not None:
                raise AssertionError(f"{name}: the fused engine took a kind it lacks")
            d = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                         s.make_data(torch.as_tensor(m.neutral_q(), device=self.dev)))
            tips = make_fk(m, s.problem.tip_links)(qt)
            d["primary"][0]["position"] = tips.pos[:, :1].contiguous()
            d["primary"][0]["orientation"] = tips.quat[:, :1].contiguous()
            g1, gd1 = s.problem.primary[1], d["primary"][1]
            packed = torch.cat([tips.pos, tips.quat], -1)
            if g1.kind == "touch":
                # the plane through the surface's deepest point at q*
                slot = int(g1.tip_slots[0])
                world = tips.pos[:, slot, None] + quat_rotate(tips.quat[:, slot, None],
                                                              gd1["points"][:, 0])
                gd1["position"] = world[torch.arange(B), world[..., 2].argmin(-1)][:, None]
            if g1.kind == "balance":
                coms = g1.index("coms", self.dev).float()
                mass = g1.index("mass_frac", self.dev).float()
                sl = g1.index("tip_slots", self.dev)
                com = ((tips.pos[:, sl] + quat_rotate(tips.quat[:, sl], coms))
                       * mass[:, None]).sum(-2)
                gd1["target"] = com[:, None].contiguous()
            e_star = _EVALUATORS[g1.kind](s.problem, g1, gd1, packed, qt, d)
            keys = torch.stack([torch.zeros(B), torch.arange(B)], -1).long().to(self.dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.solve_batch(keys, d)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            f0 = s.ctx.fitness_exact(d["seed_active"], d)
            f1 = s.ctx.fitness_exact(res.qa, d)
            err = (make_fk(m, [TIP])(res.q).pos - tips.pos[:, :1])[:, 0].norm(dim=-1)
            out["solve"][name] = {
                "success_rate": float(res.success.float().mean()),
                "median_pos_err_m": float(err.median()),
                "extra_goal_error_at_target_max": float(e_star.max()),
                "median_fitness_seed": float(f0.median()),
                "median_fitness_solution": float(f1.median()),
                "ms_per_step": wall * 1e3 / KINDS_STEPS}
            if not (torch.isfinite(res.q).all() and (f1 <= f0).all()
                    and float(f1.median()) < 0.1 * float(f0.median())):
                bad.append(f"solve {name}")

        # counter=True on solve_until: the fused branch and the island one
        tg = make_fk(m, [TIP])(qt[:1])
        for mode in ("bio2_memetic", "jac"):
            s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
                mode=mode, dtwist=1e-3, counter=True, max_steps=64, steps_per_check=4))
            d = s.make_data(torch.as_tensor(m.neutral_q(), device=self.dev))
            d["primary"][0]["position"], d["primary"][0]["orientation"] = tg.pos[0], tg.quat[0]
            r = s.solve_until(m.neutral_q(), key=[0, 9], data=d)
            sm = s.stats.summary()
            out[f"counter_{mode}"] = {"fused": s.engine is not None, "last_steps": s.last_steps,
                                      "stats": sm, "success": bool(r.success)}
            if s.stats.steps != s.last_steps or sm["batches"] != 1:
                bad.append(f"counter {mode}")

        # params: a spec dict builds the hand-built problem
        spec = {"mode": "bio2_memetic", "dtwist": 1e-3, "threads": 2, "goals": [
            {"type": "pose", "link": TIP, "position": {"x": 0.5, "y": -0.2, "z": 0.6}},
            {"type": "touch", "link": WRIST, "position": [0, 0, 0.2], "normal": [0, 0, 1]},
            {"type": "avoid_joint_limits", "weight": 0.05}]}
        ps = params.solver_from_spec(m, spec)
        hand = IKSolver(m, [G.PoseGoal(link=TIP, position=(0.5, -0.2, 0.6)),
                            G.TouchGoal(link=WRIST, position=(0.0, 0.0, 0.2)),
                            G.AvoidJointLimitsGoal(weight=0.05)],
                        SolverConfig(mode="bio2_memetic", dtwist=1e-3, islands=2))
        la = [x for x in _leaves(ps.make_data(m.neutral_q()))]
        lb = [x for x in _leaves(hand.make_data(m.neutral_q()))]
        same = (ps.config == hand.config and len(la) == len(lb)
                and all(x.device.type == self.dev.type and torch.equal(x, y)
                        for x, y in zip(la, lb))
                and [g.kind for g in ps.problem.primary + ps.problem.secondary]
                == [g.kind for g in hand.problem.primary + hand.problem.secondary])
        out["params_same_problem"] = bool(same)
        if not same:
            bad.append("params")
        emit(out)
        if bad:
            raise AssertionError(f"island_kinds: {bad}")

    @staticmethod
    def _profile(s, data, keys):
        """torch.profiler over one warm solve_batch (:meth:`_profile_call`)."""
        return Smoke._profile_call(lambda: s.solve_batch(keys, data))

    @staticmethod
    def _profile_call(fn, warm=True):
        """torch.profiler over one call of ``fn``, after a warm-up call
        unless the caller has just made one (``warm=False``): device time by
        kernel name and the device's busy share of the host-clock wall time.
        It records the device's activity only: the host-side operator
        events of a species path (~10⁵ a solve_batch) took tens of seconds
        to gather and were not read."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if warm:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
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
                "device_ops": len(ev), "device_launches": sum(e.count for e in ev),
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
        urdf = SPECIES_PATHS[0][0]
        rng = []
        for path, batch, reg in (("species", SPECIES_PATHS[0][1], False),
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
        shape, CUDA events: at the group size G the wrapper chooses and, at
        the first shape, every G, beside its bounds: ``bound_ms``, the larger of FP32 (the
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
                # every G at the first launch shape, the chosen one after
                every = key == "ms" and (N, steps) == tuple(shapes[0])
                for g in mega.groups if every else (G,):
                    run = lambda: mega(state, consts, seed=99, salt=salt, group=g)  # noqa: E731
                    run()
                    torch.cuda.synchronize()
                    by[g] = cuda_ms(run, 1)
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
            split[mode] = cuda_ms(run, 3)
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
            # every G that fits at the first launch shape, the chosen one
            # at the others
            first = (N, steps) == tuple(shapes[0])
            for g in self._fitting_groups(mega, N) if first else [G]:
                run = lambda: mega(state, consts, seed=99, salt=salt, group=g)  # noqa: E731
                run()
                torch.cuda.synchronize()
                by[g] = cuda_ms(run, 1)
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
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep

        s_kinds = HIGH_DOF["snake"][2]
        h_kinds = HIGH_DOF["humanoid"][2]
        gen = tuple((name, name, robot, kinds, terms, [self._gen_lanes(name)])
                    for name, robot, kinds, terms in GEN_CASES)
        from bio_ik_tpu_torch.tools.bench_suite import ROWS

        ur5 = ROWS["ur5_pose"]
        for name, key, robot, kinds, terms, shapes in (
                ("megastep_ur5", "ur5_pose", "ur5", ("pose",), (),
                 phase_shapes(ur5["phases"], ur5["fractions"], B_SUITE)),
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
                 h_kinds, REG_TERMS, reg[:1])) + gen:
            out = {"phase": "times", "robot": robot, "path": key, "gpu": smi_line()}
            Megastep.launches = 0
            rows = self._wide_rows(shapes, kinds, terms, robot)
            out["launches_timed"] = Megastep.launches
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
            one_step_ms = cuda_ms(lambda: mega(state, consts, seed=99, salt=salt), 1)
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
                launches_timed=out["launches_timed"],
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
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import (
            SpeciesKernel, quat_mask, species_bytes_per_lane, species_flops_per_lane,
            species_philox_calls_per_lane)
        from bio_ik_tpu_torch.kernels.build import load, ptxas_table

        int_clocks, sm_clocks = self._philox_clocks()
        fp32_rate = FP32_PER_SM_CLK * sm_clocks
        rows = []
        # the three paths of the prebuilt instances, then path (iii) of
        # shapes_main on its generated (10, 2, 8) instance
        for urdf, B, terms, kinds in [(u, b, (), ("pose",)) for u, b, _ in SPECIES_PATHS] + [
                (SPECIES_PATHS[0][0], B_SPECIES_SEC, REG_TERMS, ("pose",)),
                (GEN_SPECIES[1], B_FREE_PO, (), GEN_SPECIES[2])]:
            N = B * SPECIES_ISLANDS * 2
            kern, (args, kw) = self._species_args(urdf, N, sec_terms=terms, philox=True,
                                                  kinds=kinds)
            sp = kern.sp
            lib = load(kern.source)
            lib.species_smem_bytes.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint]
            lib.species_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [ctypes.c_uint] + [
                ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            ptx = {r["entry"]: r for r in ptxas_table(kern.source)}
            row = {"robot": urdf, "sec_terms": terms, "lanes": N, "V": sp.V, "K": sp.K,
                   "source": kern.source}
            for mode, run in (("ms", lambda: kern(*args, seed=99, step=0, **kw)),
                              ("plain_ms", lambda: self._species_philox_plain(
                                  kern, args, kw, 99, 0))):
                run()
                torch.cuda.synchronize()
                row[mode] = cuda_ms(run, 3 if mode == "ms" else 1)
            del args, kw
            kern, targs = self._species_args(urdf, N, sec_terms=terms, kinds=kinds)
            Megastep.launches, SpeciesKernel.launches = 0, 0
            run = lambda: kern(*targs)  # noqa: E731
            run()
            torch.cuda.synchronize()
            row["noise_tensor_ms"] = cuda_ms(run, 3)
            row["launches_timed"] = SpeciesKernel.launches
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
            regularized_ms=rows[2]["ms"],
            regularized_noise_tensor_ms=rows[2]["noise_tensor_ms"])
        g = rows[3]
        self.kernels[GEN_SPECIES[0]].update(
            ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
            bound_by=g["bound_by"], int_bound_ms=g["int_bound_ms"],
            noise_tensor_ms=g["noise_tensor_ms"], lanes=g["lanes"],
            noise_tensor_bound_ms=g["noise_tensor_bound_ms"], smem_bytes=g["smem_bytes"],
            blocks_per_sm=g["blocks_per_sm"], registers=g["ptxas"].get("registers"),
            spill_stores=g["ptxas"].get("spill_stores", 0))

    # ------------------------------------------------------------ sec --
    def sec_check(self):
        """The secondary-goal instances against their plain versions: the
        megastep at the regularized path's phase-1 lanes (two steps) in
        noise-tensor and in-kernel Philox mode (keep draw included), with
        the regularized path's terms and with all four; the species kernel
        with the same terms at species path (b)'s launch shape, bitwise.

        With the regularized path's terms also the floor between two correct
        versions (the plain version on the CPU against itself on the card,
        on all its lanes) and two controls, wrong versions that
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

    def _wide_fullstep_check(self, robot="dual", kinds=None, time_lanes=None, name=None):
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
        and the plain version's time.  With ``kinds`` (a generated
        instance's goal kinds, instance k on tip k mod T) it runs those
        alone and records them under the kernel row ``name``."""
        import torch
        from bio_ik_tpu_torch.kernels.bio2_fullstep import LINK_KINDS, array_draw_gen
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            Fullstep, fullstep_bytes_per_lane, megastep_flops_per_lane, philox_draw)
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
        from bio_ik_tpu_torch.kernels.checks import (HIGH_DOF, axis_negated,
                                                     lane_agreement, max_abs_err)

        card, cpu, tips = self.robots[robot]
        V = card.nvars
        if kinds is not None:
            runs, path_kinds = [tuple(kinds)], tuple(kinds)
        elif robot == "dual":
            runs = [("pose", kind) for kind in LINK_KINDS]
            path_kinds = MG_KINDS
        else:
            path_kinds = HIGH_DOF[robot][2]
            runs = [path_kinds] + [path_kinds[:-1] + (kind,) for kind in LINK_KINDS
                                   if len(path_kinds) > 1]
        time_lanes = time_lanes or (
            phase_shapes(MG_PHASES, MG_FRACTIONS, B_MG)[0][0] if robot == "dual"
            else phase_shapes(HB_PHASES, HB_FRACTIONS, B_HB)[0][0])
        T = len(tips)
        N, n = N_WIDE_CHECK, N_WIDE_FLOOR
        out = {"phase": "fullstep_check", "robot": robot,
               "instance": [V, len(path_kinds), len(tips)], "lanes": N}
        worst, controls, errs = 1.0, [], []
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2

        def fullstep(kinds, model=None, inst_tip=None):
            K = len(kinds)
            return Fullstep(model or card, list(tips), list(range(V)),
                            [k % T for k in range(K)] if inst_tip is None else inst_tip,
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
            if K > 1 and T > 1:
                wrong["tips_permuted"] = (fullstep(kinds, inst_tip=[(k + 1) % T
                                                                    for k in range(K)]),
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
        fields = dict(
            launches=launches, agree_frac=worst, max_abs_err=max(errs), ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if bound > ops_ms else "operations", philox_ms=ms_p,
            philox_bound_ms=bound_p, lanes=N)
        if name is None:
            self.kernels[f"fullstep_{robot}"].update(fields)
        else:           # a generated instance's row keeps its fullstep entry's
            self.kernels[name].update({f"fullstep_{k}": v for k, v in fields.items()})
        del state, consts, noise, args
        torch.cuda.empty_cache()

    # --------------------------------------------------------- shapes --
    def _gen_lanes(self, name):
        """(lanes, n_steps) of the first launch of a generated instance's
        path: shapes_main's (i) and (ii), the arm's main ladder for the
        lookat alone, humanoid_main's for the two hands."""
        return {"megastep_7x2x1": phase_shapes()[0],
                "megastep_7x1x1_wide": phase_shapes()[0],
                "megastep_17x3x3": phase_shapes(DUAL_PHASES, DUAL_FRACTIONS, B_DUAL_HEAD)[0],
                "megastep_30x2x2": phase_shapes(HB_PHASES, HB_FRACTIONS, B_HB)[0]}[name]

    def shapes_check(self):
        """The instances generated on first use against their plain versions:
        each megastep instance of GEN_CASES with :meth:`_wide_fk_check`
        (exact FK and fitness, no selection, on its path's first-launch
        lanes), :meth:`_wide_check` (lane agreement over two steps against
        its CPU-vs-card floor, two wrong plain versions, every group size it
        builds bitwise equal to the smallest, Philox mode) and its fullstep
        entry (:meth:`_wide_fullstep_check` on its goal kinds); the
        generated species instance bitwise against its plain version in
        Philox mode under CLT4 and with noise tensors, on path (iii)'s
        131 072 lanes."""
        import torch
        from bio_ik_tpu_torch.kernels.checks import max_abs_err

        for name, robot, kinds, terms in GEN_CASES:
            mega, sp = self._wide(1, kinds, terms, robot=robot)
            assert mega.instance.generated, mega.instance
            N = self._gen_lanes(name)[0]
            self._wide_fk_check(name, kinds, terms, robot=robot, N=N)
            row = self._wide_check(kinds, terms, robot=robot)
            emit({"phase": "shapes_check", "kernel": name, "source": mega.source,
                  "instance": [sp.V, sp.K, len(self.robots[robot][2])], **row})
            self.kernels[name].update(
                agree_frac=row["agree_frac"], philox_agree_frac=row["philox_agree_frac"],
                floor_agree_frac=row["plain_cpu_vs_card_agree_frac"],
                group=row["group_chosen"], groups=list(mega.groups))
            self._wide_fullstep_check(robot, kinds=kinds, time_lanes=N, name=name)
        name, urdf, kinds = GEN_SPECIES
        N = B_FREE_PO * SPECIES_ISLANDS * 2
        out = {"phase": "shapes_check", "kernel": name, "lanes": N}
        kern, args = self._species_args(urdf, N, kinds=kinds)
        assert kern.source.startswith("species_gen_"), kern.source
        k_out, p_out = kern(*args), kern.inner(*args)
        torch.cuda.synchronize()
        out.update(source=kern.source, noise_tensor_bitwise_frac=bitwise_frac(k_out, p_out, N))
        errs = [max(max_abs_err(a, b) for a, b in zip(k_out, p_out))]
        del args, k_out, p_out
        kern, (args, kw) = self._species_args(urdf, N, philox=True, kinds=kinds)
        k_out = kern(*args, seed=2024, step=5, **kw)
        p_out = self._species_philox_plain(kern, args, kw, 2024, 5)
        torch.cuda.synchronize()
        out["philox_bitwise_frac"] = bitwise_frac(k_out, p_out, N)
        errs.append(max(max_abs_err(a, b) for a, b in zip(k_out, p_out)))
        emit(out)
        self.kernels[name].update(agree_frac=min(out["noise_tensor_bitwise_frac"],
                                                 out["philox_bitwise_frac"]),
                                  max_abs_err=max(errs))
        del args, kw, k_out, p_out
        torch.cuda.empty_cache()
        if min(out["noise_tensor_bitwise_frac"], out["philox_bitwise_frac"]) < 1.0:
            raise AssertionError(f"the generated species instance is not bitwise its "
                                 f"plain version on every lane: {out}")

    @staticmethod
    def _bar(path):
        """A shapes_main path's success bar: SHAPES_BARS, or the JAX
        package's own success on its targets less 0.01 where that is
        lower."""
        jax_success = JAX_SHAPES_SUCCESS[path]
        return SHAPES_BARS[path] if jax_success is None else min(
            SHAPES_BARS[path], jax_success - 0.01)

    def _lookat_err(self, s, data, fk, q):
        """The median lookat error (problem._EVALUATORS, without its weight)
        of the returned configurations ``q`` under ``s``'s problem."""
        import torch
        from bio_ik_tpu_torch.problem import _EVALUATORS

        p = s.problem
        li = [grp.kind for grp in p.primary].index("lookat")
        t = fk(q)
        tips = torch.cat([t.pos, t.quat], -1)
        return float(_EVALUATORS["lookat"](p, p.primary[li], data["primary"][li], tips,
                                           None, None)[:, 0].median())

    def shapes_main(self):
        """This slice's paths at full width on instances generated on first
        use: (i) pr2_arm PositionGoal + LookAtGoal at 1 cm on the main
        ladder, B = 65 536, the lookat error beside a solve with the
        LookAtGoal at weight 0; (ii) pr2_dual's two PoseGoals, the head's
        LookAtGoal at the grippers' midpoint and the regularizers at 0.1,
        dtwist 1 cm, the dual ladder, B = 16 384, the lookat error and the
        secondary fitness each beside its ablation; (iii) free_arm
        PositionGoal + OrientationGoal (5 mm, 5 mrad) on the species tier,
        B = 16 384; (iv) pr2_arm's LookAtGoal alone, each scenario's target
        a point of the arm's workspace, on the main ladder, B = 65 536;
        (v) the humanoid's two hands (PoseGoals at 1 cm), humanoid_main's
        ladder, B = 16 384.  Launches per solve_batch: 4 megastep, 16
        species; each path's seconds."""
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import SolverConfig

        fails = []
        # (i)
        t0 = time.perf_counter()
        cfg = SolverConfig(mode="bio2_memetic", dpos=1e-2, dtwist=float("inf"))

        def arm(weight):
            return self._dual_bench(B_ARM_LOOK, [G.PositionGoal(link=TIP), G.LookAtGoal(
                link=TIP, **{**LOOKAT, "weight": weight})], cfg, PHASES, FRACTIONS,
                robot="arm")

        s, data, keys, fk, tg, slots = arm(LOOKAT["weight"])
        eng = s.solvers[0].engine
        assert eng.mega.instance.generated and eng.mega.source == self.kernels[
            "megastep_7x2x1"].get("generated", eng.mega.source)
        warm_s = s.warmup()
        res, _, out = self._drive(s, data, keys, fk, tg, DUAL_QUEUE, len(PHASES), slots)
        s0, d0, k0, _, _, _ = arm(0.0)
        r0 = s0.solve_batch(k0, d0)
        out = {"phase": "shapes_main", "path": "arm_lookat", "instance_source": eng.mega.source,
               "warmup_s": warm_s, **out,
               "median_lookat_err": self._lookat_err(s, data, fk, res.q),
               "median_lookat_err_lookat_weight_0": self._lookat_err(s, data, fk, r0.q),
               "success_rate_lookat_weight_0": float(r0.success.float().mean()),
               "success_bar": self._bar("arm_lookat"),
               "jax_success_256": JAX_SHAPES_SUCCESS["arm_lookat"],
               "device_idle_share": self._profile(s, data, keys)["device_idle_share"],
               "seconds": time.perf_counter() - t0, "gpu": smi_line()}
        emit(out)
        self.kernels["megastep_7x2x1"]["launches"] = out["launches_per_solve_batch"]
        if out["success_rate"] < out["success_bar"]:
            fails.append(f"(i) success below its bar: {out['success_rate']}")
        if not out["median_lookat_err"] < out["median_lookat_err_lookat_weight_0"]:
            fails.append("(i) the LookAtGoal did not lower the lookat error")
        del s, data, keys, res, s0, d0, k0, r0
        # (ii)
        t0 = time.perf_counter()
        cfg = SolverConfig(mode="bio2_memetic", dtwist=1e-2)
        regs = [G.MinimalDisplacementGoal(weight=DH_WEIGHT),
                G.AvoidJointLimitsGoal(weight=DH_WEIGHT)]

        def dual(weight, with_regs=True):
            goals = [G.PoseGoal(link=t) for t in DUAL_TIPS] + [G.LookAtGoal(
                link=HEAD, **{**LOOKAT, "weight": weight})] + regs * with_regs
            s, data, keys, fk, tg, slots = self._dual_bench(
                B_DUAL_HEAD, goals, cfg, DUAL_PHASES, DUAL_FRACTIONS, robot="dual_head")
            li = [grp.kind for grp in s.problem.primary].index("lookat")
            data["primary"][li]["target"] = (0.5 * (tg.pos[:, 0] + tg.pos[:, 1]))[:, None] \
                .contiguous()
            return s, data, keys, fk, tg, slots

        s, data, keys, fk, tg, slots = dual(LOOKAT["weight"])
        eng = s.solvers[0].engine
        assert eng.mega.instance.generated and eng.sec_terms == REG_TERMS
        warm_s = s.warmup()
        res, qa, out = self._drive(s, data, keys, fk, tg, DUAL_QUEUE, len(DUAL_PHASES), slots)
        p = s.problem
        s1, d1, k1, _, _, _ = dual(0.0)
        r1 = s1.solve_batch(k1, d1)
        s2, d2, k2, _, _, _ = dual(LOOKAT["weight"], with_regs=False)
        r2 = s2.solve_batch(k2, d2)
        active = p.active_vars
        out = {"phase": "shapes_main", "path": "dual_head", "instance_source": eng.mega.source,
               "warmup_s": warm_s, **out,
               "median_lookat_err": self._lookat_err(s, data, fk, res.q),
               "median_lookat_err_lookat_weight_0": self._lookat_err(s, data, fk, r1.q),
               "median_secondary_fitness": float(p.fitness_secondary(qa, data).median()),
               "median_secondary_fitness_without_regularizers": float(
                   p.fitness_secondary(r2.q[:, torch.as_tensor(active, device=r2.q.device)],
                                       data).median()),
               "ablation_success_rates": [float(r1.success.float().mean()),
                                          float(r2.success.float().mean())],
               "success_bar": self._bar("dual_head"),
               "jax_success_256": JAX_SHAPES_SUCCESS["dual_head"],
               "device_idle_share": self._profile(s, data, keys)["device_idle_share"],
               "seconds": time.perf_counter() - t0, "gpu": smi_line()}
        emit(out)
        self.kernels["megastep_17x3x3"]["launches"] = out["launches_per_solve_batch"]
        if out["success_rate"] < out["success_bar"]:
            fails.append(f"(ii) success below its bar: {out['success_rate']}")
        if not out["median_lookat_err"] < out["median_lookat_err_lookat_weight_0"]:
            fails.append("(ii) the LookAtGoal did not lower the lookat error")
        if not (out["median_secondary_fitness"]
                < out["median_secondary_fitness_without_regularizers"]):
            fails.append("(ii) the regularizers did not lower the secondary fitness")
        del s, data, keys, res, s1, d1, k1, r1, s2, d2, k2, r2
        # (iii)
        t0 = time.perf_counter()
        out, fail = self._species_drive(GEN_SPECIES[1], B_FREE_PO, orientation=True,
                                        bar=self._bar("free_posori"))
        assert out["instance_source"] == self.kernels[GEN_SPECIES[0]].get(
            "generated", out["instance_source"]), out["instance_source"]
        out = {"phase": "shapes_main", "path": "free_posori", **out,
               "success_bar": self._bar("free_posori"),
               "jax_success_256": JAX_SHAPES_SUCCESS["free_posori"],
               "seconds": time.perf_counter() - t0, "gpu": smi_line()}
        emit(out)
        self.kernels[GEN_SPECIES[0]]["launches"] = out["launches_per_solve_batch"]
        if fail:
            fails.append(f"(iii) {fail}")
        # (iv) and (v): the two generated instances no JAX suite row names
        for path, name, robot, goals, B, phases, fractions, queue in (
                ("arm_lookat_alone", "megastep_7x1x1_wide", "arm",
                 [G.LookAtGoal(link=TIP, **LOOKAT)], B_ARM_LOOK, PHASES, FRACTIONS,
                 DUAL_QUEUE),
                ("humanoid_two_hands", "megastep_30x2x2", "humanoid_hands",
                 [G.PoseGoal(link=t) for t in self.robots["humanoid_hands"][2]], B_HB,
                 HB_PHASES, HB_FRACTIONS, HB_QUEUE)):
            t0 = time.perf_counter()
            cfg = SolverConfig(mode="bio2_memetic", dpos=1e-2, dtwist=float("inf"))
            s, data, keys, fk, tg, slots = self._dual_bench(B, goals, cfg, phases, fractions,
                                                            robot=robot)
            eng = s.solvers[0].engine
            assert eng.mega.instance.generated and eng.mega.source == self.kernels[
                name].get("generated", eng.mega.source)
            lookat = path == "arm_lookat_alone"
            if lookat:
                data["primary"][0]["target"] = tg.pos[:, :1].contiguous()
            res, _, out = self._drive(s, data, keys, fk, tg, queue, len(phases),
                                      slots or (0,))
            out = {"phase": "shapes_main", "path": path, "instance_source": eng.mega.source,
                   **out, "success_bar": SHAPES_BARS[path]}
            if lookat:          # no position goal: the lookat error instead
                del out["median_pos_err_m"]
                seed = torch.as_tensor(self.model.neutral_q(), device=self.dev).expand(B, -1)
                out.update(median_lookat_err=self._lookat_err(s, data, fk, res.q),
                           median_lookat_err_seed=self._lookat_err(s, data, fk, seed))
                if not out["median_lookat_err"] < out["median_lookat_err_seed"]:
                    fails.append(f"({path}) the lookat error did not fall from the seed's")
            elif not out["median_pos_err_m"] <= 1e-3:
                fails.append(f"({path}) median position error above 1 mm: {out}")
            out.update(seconds=time.perf_counter() - t0, gpu=smi_line())
            emit(out)
            self.kernels[name]["launches"] = out["launches_per_solve_batch"]
            if out["success_rate"] < out["success_bar"]:
                fails.append(f"({path}) success below its bar: {out['success_rate']}")
            del s, data, keys, res
        if fails:
            raise AssertionError(f"shapes_main: {fails}")

    # --------------------------------------------------------- native --
    def native(self):
        """The port's float64 C++ oracle (``bio_ik_tpu_torch.native``, built
        with g++ here): the card's float32 FK within NATIVE_ATOL of it on
        NATIVE_N configurations of each of NATIVE_ROBOTS (position, and the
        quaternion up to sign), and its support point equal to an argmax of
        the dot product on the card, on a random hull."""
        import numpy as np
        import torch
        from bio_ik_tpu_torch import RobotModel, asset_path, make_fk, native

        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("the native oracle did not build or load (g++)")
        out = {"phase": "native", "library": os.path.relpath(native.library_path(), ROOT),
               "build_s": time.perf_counter() - t0, "configurations": NATIVE_N,
               "atol": NATIVE_ATOL}
        for urdf, tips in NATIVE_ROBOTS:
            m = RobotModel.from_urdf_file(asset_path(urdf))
            b = m._np_bounds
            q = np.random.default_rng(0).uniform(b["min"], b["max"], size=(
                NATIVE_N, m.nvars)).astype(np.float32)
            pos, quat = native.oracle_fk(m, q, list(tips))
            f = make_fk(m, list(tips))(torch.as_tensor(q, device=self.dev))
            gp, gq = f.pos.double().cpu().numpy(), f.quat.double().cpu().numpy()
            sign = np.sign(np.sum(gq * quat, axis=-1, keepdims=True))
            out[urdf] = {"tips": list(tips), "pos_max_abs_err": float(np.abs(gp - pos).max()),
                         "quat_max_abs_err": float(np.abs(gq - sign * quat).max())}
        rng = np.random.default_rng(1)
        pts, dirs = rng.normal(size=(4096, 3)), rng.normal(size=(64, 3))
        got = [native.support_point(pts, d) for d in dirs]
        want = (torch.as_tensor(pts, device=self.dev) @ torch.as_tensor(
            dirs, device=self.dev).T).argmax(0).tolist()
        out["support_point_agree"] = got == want
        emit(out)
        errs = [max(out[u]["pos_max_abs_err"], out[u]["quat_max_abs_err"])
                for u, _ in NATIVE_ROBOTS]
        if not (max(errs) <= NATIVE_ATOL and out["support_point_agree"]):
            raise AssertionError(f"the card's FK or the support point disagree with "
                                 f"the native oracle: {out}")

    # ---------------------------------------------------------- suite --
    def suite(self):
        """The JAX suite's ur5_pose and kuka_iiwa_pose rows through the port's
        ``bench_suite`` (its JSON lines) at B_SUITE, each held to
        SUITE_LIMITS; ur5_pose's launches are the (6, 1, 1) kernel's."""
        from bio_ik_tpu_torch.tools import bench_suite

        fails = []
        for name, (success, median, launches) in SUITE_LIMITS.items():
            row = bench_suite.run_row(name, batch=B_SUITE)
            if name == "ur5_pose":
                self.kernels["megastep_ur5"]["launches"] = row["launches"]
            if not (row["success_rate"] >= success and row["median_pos_err_m"] <= median
                    and row["launches"] == launches and row["engine"] == "fused"):
                fails.append(row)
        if fails:
            raise AssertionError(f"suite rows outside their limits {SUITE_LIMITS}: {fails}")

    # ------------------------------------------------------- parallel --
    def parallel(self):
        """The sharded solves (``tools/parallel_check``): a world of one over
        NCCL — the batch-sharded solve of the main configuration at B_MAIN
        bitwise ``solve_batch``, the fused island-sharded solve of 8 single
        queries (success ≥ 0.99 without migration, bitwise the single
        query; and with migration), the island path's at 4 steps bitwise
        ``IKSolver.solve`` —; then a world of two over gloo on the one card
        (two spawned processes): the batch-sharded result at B_WORLD_TWO
        bitwise the halves' ``solve_batch``, the island-sharded solve with
        migration the same on both ranks and better than the seed.  Each
        row with its megastep launches and ms."""
        from bio_ik_tpu_torch.tools import parallel_check

        # NCCL's bootstrap on the loopback device (the machine has no network)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        rows = parallel_check.world_one("cuda", B=B_MAIN)
        for row in rows:
            emit({"phase": "parallel", "world": 1, "backend": "nccl", **row})
        fused = [r for r in rows if r["row"] == "island_sharded_fused" and not r["migrate"]]
        self._profile_island_sharded()
        for row in parallel_check.world_two("cuda", B=B_WORLD_TWO):
            emit({"phase": "parallel", **row})
        if fused[0]["success_rate"] < 0.99:
            raise AssertionError(f"the island-sharded single queries succeed below 0.99: "
                                 f"{fused}")

    def _profile_island_sharded(self):
        """Device launches, busy time and idle share of one fused
        island-sharded query (64 steps) with and without migration, in a
        world of one over NCCL (:meth:`_profile_call`)."""
        import torch.distributed as dist
        from bio_ik_tpu_torch.parallel.distributed import initialize_distributed
        from bio_ik_tpu_torch.parallel.islands import default_mesh, make_sharded_island_solve
        from bio_ik_tpu_torch.tools import parallel_check

        initialize_distributed(parallel_check.free_address(), 1, 0)
        try:
            p = parallel_check.BenchProblem("cuda", 8)
            s, mesh = p.solver_with(max_steps=64), default_mesh("islands")
            key, data = p.query(0)
            for migrate in (False, True):
                solve = make_sharded_island_solve(s, mesh, migrate=migrate)
                emit({"phase": "parallel", "row": "profile_island_sharded_fused",
                      "migrate": migrate, **self._profile_call(lambda: solve(key, data))})
        finally:
            dist.destroy_process_group()

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

# phases that launch no hand-written kernel: they run while `build` compiles
KERNEL_FREE = ("unfused_modes", "other_modes", "native")


def timed(table, fn, name):
    """``fn`` adding its inclusive seconds and calls to ``table[name]``."""
    import functools

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            row = table.setdefault(name, [0.0, 0])
            row[0] += time.perf_counter() - t0
            row[1] += 1
    return wrapper


def time_everything(table):
    """Wrap every method of :class:`Smoke` and the module-level helpers of
    this script and of the modules it times (input makers, bench_latency)
    with :func:`timed`: where the smoke's own seconds go."""
    from bio_ik_tpu_torch.kernels import checks
    from bio_ik_tpu_torch.tools import bench_latency

    for name, fn in list(vars(Smoke).items()):
        if isinstance(fn, staticmethod):
            setattr(Smoke, name, staticmethod(timed(table, fn.__func__, name)))
        elif callable(fn) and not name.startswith("__"):
            setattr(Smoke, name, timed(table, fn, name))
    here = sys.modules[__name__]
    for mod, names in ((here, ("cuda_ms", "agree_frac", "philox_sass_count", "smi_line")),
                       (checks, ("megastep_inputs", "species_inputs", "lane_agreement")),
                       (bench_latency, [n for n in dir(bench_latency) if n.startswith("run")])):
        for n in names:
            if callable(getattr(mod, n, None)):
                setattr(mod, n, timed(table, getattr(mod, n), f"{mod.__name__}.{n}"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="build,unfused_modes,other_modes,native,check,rng,"
                    "sec_check,fullstep_check,shapes_check,latency_check,main,"
                    "regularized_main,dual_main,multigoal_main,snake_main,humanoid_main,"
                    "shapes_main,suite,parallel,latency,island_kinds,"
                    "species_check,species_main,species_sec_main,times,profile,mfu",
                    help="comma-separated phases to run")
    ap.add_argument("--timings", metavar="PATH",
                    help="write each method's and helper's inclusive seconds "
                    "and calls to PATH as JSON")
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
    table = {}
    if args.timings:
        time_everything(table)
    smoke = Smoke()
    phases = args.only.split(",")

    def join_build():
        if getattr(smoke, "build_thread", None):
            smoke.build_join()
            emit({"phase_seconds": {"build": time.perf_counter() - smoke.build_t0}})

    try:
        for name in phases:
            if name not in KERNEL_FREE:
                join_build()
            t0 = time.perf_counter()
            getattr(smoke, name)()
            if name != "build":
                emit({"phase_seconds": {name: time.perf_counter() - t0}})
        join_build()
    finally:
        # a failing phase does not leave nvcc running after the script
        if getattr(smoke, "build_thread", None):
            smoke.build_thread.join()
        if args.timings:
            with open(args.timings, "w") as f:
                json.dump(dict(sorted(table.items(), key=lambda kv: -kv[1][0])), f, indent=0)
    k = smoke.kernels
    emit({"kernels": [dict(
        name=name, route="cuda", source=f"bio_ik_tpu_torch/csrc/{src}",
        replaces=replaces, launches=k[name].get("launches"),
        max_abs_err=k[name].get("max_abs_err"), ms=k[name].get("ms"),
        plain_ms=k[name].get("plain_ms"), bound_ms=k[name].get("bound_ms"),
        bound_by=k[name].get("bound_by"), library_ms=None,
        **{x: v for x, v in k[name].items() if x not in KERNEL_KEYS})
        for name, src, replaces in (
            ("megastep", "megastep.cu", MEGASTEP_TPU),
            ("megastep_ur5", "megastep.cu", MEGASTEP_TPU),
            ("megastep_dual", "megastep_wide.cu", MEGASTEP_TPU),
            ("megastep_dual_sec", "megastep_wide.cu", MEGASTEP_TPU),
            ("megastep_snake", "megastep_high.cu", MEGASTEP_TPU),
            ("megastep_snake_sec", "megastep_high.cu", MEGASTEP_TPU),
            ("megastep_humanoid", "megastep_high.cu", MEGASTEP_TPU),
            ("megastep_humanoid_sec", "megastep_high.cu", MEGASTEP_TPU),
            ("species", "species.cu", SPECIES_TPU),
            ("fullstep", "megastep.cu", FULLSTEP_TPU),
            ("fullstep_dual", "megastep_wide.cu", FULLSTEP_TPU),
            ("fullstep_snake", "megastep_high.cu", FULLSTEP_TPU),
            ("fullstep_humanoid", "megastep_high.cu", FULLSTEP_TPU),
            ("peak", "peak.cu", "tools/bench_mfu.py:85"))
            # the generated instances: the header, and the shape in "generated"
            + tuple((name, "megastep.cuh", MEGASTEP_TPU) for name, *_ in GEN_CASES)
            + ((GEN_SPECIES[0], "species.cuh", SPECIES_TPU),)]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
