#!/usr/bin/env python
"""A/B of the megastep kernel on the card against a parent build: times at
the launch shapes of the paths' retry ladders, and the share of lanes whose
outputs are bitwise the parent's.

The shapes are ``chip_smoke.py``'s: bench.py's main ladder (PR2 arm,
pose-only kernel; 131 072 / 39 320 / 15 728 / 8 384 lanes at 24 / 32 / 64
/ 32 steps), the regularized ladder (the secondary-goal kernel with the
MinimalDisplacement and AvoidJointLimits terms; 131 072 / 78 640 / 52 424
/ 31 456 lanes at 32 / 64 / 128 / 256 steps), the two PR2 dual-arm ladders
on the wide (17, 2, 2) instance (``pr2_dual_pose2``, two PoseGoals, B =
16 384; ``pr2_dual_multigoal``, PoseGoal + LookAtGoal with the two
regularizers, B = 65 536), the snake's four launches of 4 steps on 524 288
lanes (``snake32_position``), the humanoid's 1 cm and 1 mm ladders
(``humanoid_whole_body``, B = 16 384; ``_mm``, B = 4 096) on the high-DOF
instances, and the first launches of the generated (17, 3, 3) instance
(shapes_main (ii): both grippers' poses and the head's lookat with the
regularizers, 32 768 × 64) and (30, 2, 2) (shapes_main (v): the humanoid's
two hands, 32 768 × 32), and the main ladder's shapes on the generated
(7, 2, 1) (shapes_main (i): PositionGoal + LookAtGoal) and (7, 1, 1)
(shapes_main (iv): a LookAtGoal alone) instances.  In-kernel Philox, inputs from
``kernels/checks.megastep_inputs``.  Versions, timed with CUDA events in
one process on one card, in the order given:

  * ``change`` — the sources of ``csrc/`` (and the instances generated from
    them) through ``Megastep`` at the group size or width the wrapper
    chooses (``--every-width``: also at every width the change builds);
  * ``parent`` — the previous version of the sources, from ``--parent
    DIR`` holding its ``megastep.cu``, ``megastep_wide.cu``,
    ``megastep_high.cu`` and headers (its generated instances are built
    from its ``megastep.cuh`` with the group sizes its wrapper gave them:
    G = 2 from 24 variables, else 1, 2, 4).  It is launched through the C
    API of version 3 (``megastep_abi_version() == 3``), at the group size
    the parent wrapper's rule (:func:`choose_group`) picks from the parent
    build's occupancy among the parent's group sizes; a build of another
    version is refused, as its list differs.

Then, per wide, high-DOF and generated instance, pose-only and with
secondary goals, one launch of ``megastep_inputs`` (16 384 lanes, 2
steps, Philox): the share of lanes whose six state outputs are
bitwise the parent's, at every width the change builds; and, to find an
expression that rounds otherwise, the same share by stage — one step of
no generation and no memetic iteration (the exact FK and fitness), of one
generation, of one memetic iteration — and by output row.

Prints one JSON line per (ladder, shape, version), a summary line, the
bitwise lines, and both builds' ``-Xptxas -v`` rows (registers, stack,
spill per kernel) with the entries whose rows differ.  The parent sources
are a measuring aid only: nothing on a solve path loads them.

Usage (on the card)::

    python -m bio_ik_tpu_torch.tools.megastep_ab --parent build/parent_src \\
        --order parent,change,change,parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import threading

import torch

from bio_ik_tpu_torch import RobotModel, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_megastep import (MEGASTEP_SOURCES, Megastep,
                                                    _MEMETIC_CODE, _ptr, choose_group)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.build import (BUILD_DIR, EXTRA_FLAGS, NVCC_FLAGS, _nvcc,
                                            build_all, ptxas_rows, ptxas_table)
from bio_ik_tpu_torch.kernels.checks import HIGH_DOF, megastep_inputs

TIP = "r_gripper_tool_frame"
DUAL_TIPS = ("r_gripper_tool_frame", "l_gripper_tool_frame")
HEAD = "head_tilt_link"
HANDS = ("r_hand", "l_hand")
REG_TERMS = ("beta", "gamma")
# (label, urdf, tips, goal kinds, secondary terms, B, phases, fractions);
# B None: the phases are the launch shapes themselves
LADDERS = (
    ("main", "pr2_arm.urdf", (TIP,), ("pose",), (), 65536,
     ((1, 24), (2, 32), (4, 64), (8, 32)), (0.15, 0.03, 0.008)),
    ("regularized", "pr2_arm.urdf", (TIP,), ("pose",), REG_TERMS, 65536,
     ((1, 32), (2, 64), (4, 128), (8, 256)), (0.3, 0.1, 0.03)),
    ("pose2", "pr2_dual.urdf", DUAL_TIPS, ("pose", "pose"), (), 16384,
     ((1, 64), (2, 64), (4, 128), (8, 128)), (0.25, 0.08, 0.03)),
    ("multigoal", "pr2_dual.urdf", DUAL_TIPS, ("pose", "lookat"), REG_TERMS, 65536,
     ((1, 32), (2, 32), (4, 64), (8, 128)), (0.3, 0.1, 0.04)),
    ("snake", "snake.urdf", ("head",), ("position",), (), None,
     ((524288, 4),) * 4, None),
    ("humanoid", "humanoid.urdf", ("r_hand", "l_hand", "head"), ("pose",) * 3, (), 16384,
     ((1, 32), (2, 64), (4, 128), (8, 128)), (0.75, 0.25, 0.125)),
    ("humanoid_mm", "humanoid.urdf", ("r_hand", "l_hand", "head"), ("pose",) * 3, (), 4096,
     ((1, 32), (2, 64), (4, 128), (8, 256), (8, 256), (8, 256)),
     (0.75, 0.3, 0.2, 0.15, 0.12)),
    ("gen_17x3x3", "pr2_dual.urdf", DUAL_TIPS + (HEAD,), ("pose", "pose", "lookat"),
     REG_TERMS, None, ((32768, 64),), None),
    ("gen_30x2x2", "humanoid.urdf", HANDS, ("pose", "pose"), (), None, ((32768, 32),), None),
    ("gen_7x2x1", "pr2_arm.urdf", (TIP,), ("position", "lookat"), (), 65536,
     ((1, 24), (2, 32), (4, 64), (8, 32)), (0.15, 0.03, 0.008)),
    ("gen_7x1x1", "pr2_arm.urdf", (TIP,), ("lookat",), (), 65536,
     ((1, 24), (2, 32), (4, 64), (8, 32)), (0.15, 0.03, 0.008)),
)
# the instances held bitwise against the parent: (label, urdf, tips, goal
# kinds, the secondary terms of the SEC launch)
BITWISE = (
    ("dual", "pr2_dual.urdf", DUAL_TIPS, ("pose", "lookat"), REG_TERMS),
    ("snake", "snake.urdf", ("head",), HIGH_DOF["snake"][2], HIGH_DOF["snake"][3]),
    ("humanoid", "humanoid.urdf", HIGH_DOF["humanoid"][1], HIGH_DOF["humanoid"][2],
     HIGH_DOF["humanoid"][3]),
    ("gen_17x3x3", "pr2_dual.urdf", DUAL_TIPS + (HEAD,), ("pose", "pose", "lookat"),
     REG_TERMS),
    ("gen_30x2x2", "humanoid.urdf", HANDS, ("pose", "pose"), REG_TERMS),
    ("gen_7x2x1", "pr2_arm.urdf", (TIP,), ("pose", "lookat"), REG_TERMS),
    ("gen_7x1x1", "pr2_arm.urdf", (TIP,), ("lookat",), REG_TERMS),
)
# lanes of the bitwise comparison's launch
BITWISE_LANES = 16384
SOURCES = tuple(MEGASTEP_SOURCES)
# the parent's group sizes: each source's GROUPS, and a generated
# instance's by its variable count
PARENT_GROUPS = {"megastep": (1, 2, 4, 8), "megastep_wide": (1, 2, 4),
                 "megastep_high": (2,)}


def parent_gen_groups(V: int) -> tuple:
    return (2,) if V >= 24 else (1, 2, 4)


def ladder(B, phases, fractions):
    """(lanes, n_steps) of a ladder's launches (chip_smoke.phase_shapes)."""
    if B is None:
        return list(phases)
    out = []
    for i, (islands, steps) in enumerate(phases):
        b = B if i == 0 else max(1, int(B * fractions[i - 1]))
        out.append((b * islands * 2, steps))
    return out


def _parent_source(mega) -> str:
    return mega.source if not mega.instance.generated else f"{mega.source}_parent"


def parent_launch(libs, mega, state, consts, seed, salt):
    """One launch of the parent's megastep (C API version 3) of ``mega``'s
    shape on the same state, at the group size the parent wrapper's rule
    picks from the parent's occupancy."""
    lib = libs[_parent_source(mega)]
    sp = mega.sp
    dev = state[0].device
    N = state[0].shape[-1]
    groups = (PARENT_GROUPS[mega.source] if not mega.instance.generated
              else parent_gen_groups(sp.V))
    key = (N, "parent_group")
    if key not in mega._groups:
        mega._groups[key] = choose_group(N, {g: mega.resident_blocks(lib, dev, g)
                                             for g in groups if sp.C % g == 0}, sp.C)
    named = dict(zip(mega.const_names, consts))
    rows = [named[n] for n in ("qfix", "gpos", "gquat", "wpos", "wrot", "span", "cmin",
                               "cmax", "amin", "amax")]
    sec = named.get("sec", state[0])
    gaux = named.get("gaux", named["gpos"])
    unread = state[0]
    chain_i, chain_f, tip_slot, inst_tip, kinds, cols = mega._chain_on(dev)
    out = tuple(torch.empty_like(t) for t in state)
    fn = lib.megastep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                                         ctypes.c_uint]
                   + [ctypes.c_void_p] * 36 + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(sp.V, sp.K, mega.T, mega._groups[key], N, chain_i.shape[0], mega.nbranch,
            mega.n_steps, sp.gens, sp.C, sp.mem_iters, _MEMETIC_CODE[sp.memetic], sp.h, 1,
            seed, mega.sec_mask, _ptr(salt), *(_ptr(t) for t in state),
            *(_ptr(t) for t in out), *(_ptr(t) for t in rows), _ptr(sec),
            *([_ptr(unread)] * 5), _ptr(chain_i), _ptr(chain_f), _ptr(tip_slot),
            _ptr(inst_tip), _ptr(gaux), _ptr(kinds), _ptr(cols), mega.ncol,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent megastep launch failed: CUDA error {rc}")
    return out


def cuda_ms(fn, reps):
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _instance(urdf, tips, kinds, terms, steps, dev):
    model = RobotModel.from_urdf_file(asset_path(urdf), device=dev)
    V, K = model.nvars, len(kinds)
    sp = SpeciesParams(V=V, K=K)
    return Megastep(model, list(tips), list(range(V)), [k % len(tips) for k in range(K)], sp,
                    steps, sec_terms=terms, inst_kind=list(kinds)), sp


def _generated(dev):
    """The generated instances of LADDERS and BITWISE, pose-only and with
    secondary terms: {parent source name: (V, K, T, the change's name)}."""
    out = {}
    for _, urdf, tips, kinds, terms, *_ in LADDERS + BITWISE:
        for t in ((), terms):
            mega, sp = _instance(urdf, tips, kinds, t, 1, dev)
            if mega.instance.generated:
                out[_parent_source(mega)] = (sp.V, sp.K, mega.T, mega.source)
    return out


def _parent_text(V, K, T, groups):
    gx = " ".join(f"X(v, k, t, {g})" for g in groups)
    return (f"#define SHAPES(X) X({V}, {K}, {T})\n#define GROUPS(X, v, k, t) {gx}\n"
            '#define MEGASTEP_WIDE 1\n\n#include "megastep.cuh"\n')


def load_parent(src_dir, generated):
    """Build the parent's megastep sources and its generated instances
    (beside the change's builds, all at once) and load them; returns
    ``({source: CDLL}, {source: ptxas rows})``, or exits unless each speaks
    the C API of version 3."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    jobs = [(name, os.path.join(src_dir, f"{name}.cu"), EXTRA_FLAGS.get(name, []))
            for name in SOURCES]
    for pname, (V, K, T, _) in generated.items():
        path = os.path.join(BUILD_DIR, f"{pname}.cu")
        with open(path, "w") as f:
            f.write(_parent_text(V, K, T, parent_gen_groups(V)))
        jobs.append((pname, path, ["-I", src_dir, "--split-compile=0"]))
    for name, path, flags in jobs:
        out = os.path.join(BUILD_DIR, f"lib{name}_parent.so")
        procs[name] = (out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    threads = [threading.Thread(target=lambda n=n, p=p: logs.__setitem__(n, p.communicate()[0]))
               for n, (_, p) in procs.items()]
    for t in threads:
        t.start()
    build_all(list(SOURCES) + [g[3] for g in generated.values()])
    for t in threads:
        t.join()
    libs, rows = {}, {}
    for name, (out, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{logs[name][-8000:]}")
        lib = ctypes.CDLL(out)
        version = (lib.megastep_abi_version() if hasattr(lib, "megastep_abi_version")
                   else 1)
        if version != 3:
            raise SystemExit(f"megastep_ab: the parent's megastep_launch ({name}) is "
                             f"of version {version}; this tool launches version 3")
        libs[name], rows[name] = lib, ptxas_rows(logs[name])
    return libs, rows


def bitwise_frac(a, b):
    """Share of lanes whose every output row is bitwise equal (NaN equal
    to NaN)."""
    eq = None
    for x, y in zip(a, b):
        e = ((x == y) | (torch.isnan(x) & torch.isnan(y))).all(0)
        eq = e if eq is None else eq & e
    return float(eq.float().mean())


# (generations, memetic iterations) of the staged comparison's one step
STAGES = ((0, 0), (1, 0), (0, 1), (8, 8))
OUTPUTS = ("genes", "grads", "sfit", "sol", "sol_fit", "sol_tips")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="directory with the previous megastep.cu, megastep_wide.cu, "
                         "megastep_high.cu and their headers")
    ap.add_argument("--order", default="change",
                    help="comma-separated versions (parent, change), timed in "
                         "this order at each shape")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--every-width", action="store_true",
                    help="also time the change at every width (group size) it builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("megastep_ab: needs the card")
    order = args.order.split(",")
    if not set(order) <= {"parent", "change"} or ("parent" in order) != bool(args.parent):
        raise SystemExit("megastep_ab: --order takes parent and change, parent "
                         "only with --parent")
    dev = torch.device("cuda")
    generated = _generated(dev)
    parent, parent_rows = (load_parent(args.parent, generated) if args.parent
                           else (None, None))
    if not parent:
        build_all(list(SOURCES) + [g[3] for g in generated.values()])
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def emit(obj):
        print(json.dumps(obj), flush=True)

    totals = {}
    for label, urdf, tips, kinds, terms, B, phases, fractions in LADDERS:
        cpu = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
        shapes = ladder(B, phases, fractions)
        totals[label] = [0.0] * len(order)
        for N, steps in sorted(set(shapes), key=shapes.index):
            times = shapes.count((N, steps))
            mega, sp = _instance(urdf, tips, kinds, terms, steps, dev)
            state, consts, _ = megastep_inputs(cpu, list(tips), sp, steps, N,
                                               with_noise=False, sec_terms=terms,
                                               inst_kind=list(kinds))
            state, consts = tree_from_numpy(state, dev), tree_from_numpy(consts, dev)
            salt = torch.arange(N, dtype=torch.int32, device=dev)[None] // 2
            run = {"parent": lambda: parent_launch(parent, mega, state, consts, 99, salt),
                   "change": lambda: mega(state, consts, seed=99, salt=salt)}
            for i, version in enumerate(order):
                ms = cuda_ms(run[version], args.reps)
                totals[label][i] += ms * times
                emit({"ladder": label, "lanes": N, "n_steps": steps, "launches": times,
                      "version": version, "ms": ms, "gpu": gpu,
                      "group": (mega.group(mega._lib(N), dev, N) if version == "change"
                                else mega._groups.get((N, "parent_group")))})
            if args.every_width:
                lib = mega._lib(N)
                by = {}
                for g in mega.groups:
                    if mega.resident_blocks(lib, dev, g) > 0:
                        by[g] = cuda_ms(lambda: mega(state, consts, seed=99, salt=salt,
                                                     group=g), args.reps)
                emit({"ladder": label, "lanes": N, "n_steps": steps, "version": "change",
                      "ms_by_group": by, "gpu": gpu})
            del state, consts
            torch.cuda.empty_cache()
    emit({"summary": {label: [[v, ms] for v, ms in zip(order, t)]
                      for label, t in totals.items()},
          "note": "ms per ladder (the sum over its launches) of each entry of "
                  "--order, in turn", "gpu": gpu})
    if parent:
        N = BITWISE_LANES
        for label, urdf, tips, kinds, terms in BITWISE:
            cpu = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
            for t in ((), terms):
                mega, sp = _instance(urdf, tips, kinds, t, 2, dev)
                state, consts, _ = megastep_inputs(cpu, list(tips), sp, 2, N,
                                                   with_noise=False, sec_terms=t,
                                                   inst_kind=list(kinds))
                state, consts = tree_from_numpy(state, dev), tree_from_numpy(consts, dev)
                salt = torch.arange(N, dtype=torch.int32, device=dev)[None] // 2
                ref = parent_launch(parent, mega, state, consts, 4321, salt)
                lib = mega._lib(N)
                by = {g: bitwise_frac(mega(state, consts, seed=4321, salt=salt, group=g), ref)
                      for g in mega.groups if mega.resident_blocks(lib, dev, g) > 0}
                emit({"bitwise": label, "instance": [sp.V, sp.K, mega.T], "sec_terms": t,
                      "source": mega.source, "lanes": N, "n_steps": 2,
                      "parent_group": mega._groups[(N, "parent_group")],
                      "bitwise_vs_parent_frac_by_group": by,
                      "bitwise_vs_parent_frac": min(by.values())})
                for gens, mem in STAGES:
                    model = RobotModel.from_urdf_file(asset_path(urdf), device=dev)
                    ssp = SpeciesParams(V=sp.V, K=sp.K, gens=gens, mem_iters=mem,
                                        memetic="q" if mem else "")
                    smega = Megastep(model, list(tips), list(range(sp.V)),
                                     [k % len(tips) for k in range(sp.K)], ssp, 1,
                                     sec_terms=t, inst_kind=list(kinds))
                    ref = parent_launch(parent, smega, state, consts, 4321, salt)
                    out = smega(state, consts, seed=4321, salt=salt)
                    emit({"bitwise_stage": label, "sec_terms": t, "gens": gens,
                          "mem_iters": mem, "lanes": N,
                          "bitwise_vs_parent_frac": bitwise_frac(out, ref),
                          "by_output": {nm: bitwise_frac((a,), (b,))
                                        for nm, a, b in zip(OUTPUTS, out, ref)},
                          "max_abs_diff": {nm: float((a - b).abs().nan_to_num().max())
                                           for nm, a, b in zip(OUTPUTS, out, ref)}})
    names = list(SOURCES) + [g[3] for g in generated.values()]
    for name in names:
        change = ptxas_table(name)
        out = {"ptxas": name, "change": change}
        pname = next((p for p, g in generated.items() if g[3] == name), name)
        if parent_rows:
            out["parent"] = parent_rows[pname]
            old = {r["entry"]: r for r in parent_rows[pname]}
            out["entries_that_differ"] = [r["entry"] for r in change
                                          if old.get(r["entry"]) != r]
        emit(out)


if __name__ == "__main__":
    main()
