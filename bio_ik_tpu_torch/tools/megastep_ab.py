#!/usr/bin/env python
"""A/B timing of the megastep kernel on the card, at the launch shapes of
four retry ladders.

The shapes are ``chip_smoke.py``'s: bench.py's main ladder (PR2 arm,
pose-only kernel; 131 072 / 39 320 / 15 728 / 8 384 lanes at 24 / 32 / 64
/ 32 steps), the regularized ladder (the secondary-goal kernel with the
MinimalDisplacement and AvoidJointLimits terms; 131 072 / 78 640 / 52 424
/ 31 456 lanes at 32 / 64 / 128 / 256 steps), and the two PR2 dual-arm
ladders on the wide (17, 2, 2) instance: ``pr2_dual_pose2`` (two
PoseGoals, B = 16 384) and ``pr2_dual_multigoal`` (PoseGoal + LookAtGoal
with the two regularizers, B = 65 536).  In-kernel Philox, inputs from
``kernels/checks.megastep_inputs``.  Versions, timed with CUDA events in
one process on one card, in the order given:

  * ``change`` — ``csrc/megastep.cu`` and ``csrc/megastep_wide.cu``
    through ``Megastep`` at the group size the wrapper chooses;
  * ``parent`` — the previous version of the sources, from ``--parent
    DIR`` holding its ``megastep.cu``, ``megastep_wide.cu`` and headers.
    It is launched through the C API of version 3 (``megastep_abi_version()
    == 3``: the argument list with the goal kinds' ``gaux``, ``inst_kind``,
    ``cols`` and ``ncol``, at the group size the wrapper's rule picks from
    the parent build's occupancy); a build of another version is refused,
    as its list differs.

Prints one JSON line per (ladder, shape, version), a summary line, and
both builds' ``-Xptxas -v`` rows (registers, stack, spill per kernel)
with the entries whose rows differ.  The parent sources are a measuring
aid only: nothing on a solve path loads them.

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
from bio_ik_tpu_torch.kernels.bio2_megastep import (Megastep, _MEMETIC_CODE,
                                                    _ptr, choose_group)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.build import (BUILD_DIR, EXTRA_FLAGS, NVCC_FLAGS, _nvcc,
                                            build_all, ptxas_rows, ptxas_table)
from bio_ik_tpu_torch.kernels.checks import megastep_inputs

TIP = "r_gripper_tool_frame"
DUAL_TIPS = ("r_gripper_tool_frame", "l_gripper_tool_frame")
REG_TERMS = ("beta", "gamma")
# (label, urdf, tips, goal kinds, secondary terms, B, phases, fractions)
LADDERS = (
    ("main", "pr2_arm.urdf", (TIP,), ("pose",), (), 65536,
     ((1, 24), (2, 32), (4, 64), (8, 32)), (0.15, 0.03, 0.008)),
    ("regularized", "pr2_arm.urdf", (TIP,), ("pose",), REG_TERMS, 65536,
     ((1, 32), (2, 64), (4, 128), (8, 256)), (0.3, 0.1, 0.03)),
    ("pose2", "pr2_dual.urdf", DUAL_TIPS, ("pose", "pose"), (), 16384,
     ((1, 64), (2, 64), (4, 128), (8, 128)), (0.25, 0.08, 0.03)),
    ("multigoal", "pr2_dual.urdf", DUAL_TIPS, ("pose", "lookat"), REG_TERMS, 65536,
     ((1, 32), (2, 32), (4, 64), (8, 128)), (0.3, 0.1, 0.04)),
)
SOURCES = ("megastep", "megastep_wide")


def ladder(B, phases, fractions):
    """(lanes, n_steps) of a ladder's four launches (chip_smoke.phase_shapes)."""
    out = []
    for i, (islands, steps) in enumerate(phases):
        b = B if i == 0 else max(1, int(B * fractions[i - 1]))
        out.append((b * islands * 2, steps))
    return out


def parent_launch(libs, mega, state, consts, seed, salt):
    """One launch of the parent's megastep (C API version 3) of ``mega``'s
    source on the same state, at the group size the wrapper's rule picks
    from the parent's occupancy."""
    lib = libs[mega.source]
    sp = mega.sp
    dev = state[0].device
    N = state[0].shape[-1]
    if not hasattr(mega, "parent_group"):
        mega.parent_group = choose_group(N, {g: mega.resident_blocks(lib, dev, g)
                                             for g in mega.groups if sp.C % g == 0}, sp.C)
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
    rc = fn(sp.V, sp.K, mega.T, mega.parent_group, N, chain_i.shape[0], mega.nbranch,
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


def load_parent(src_dir):
    """Build the parent's megastep sources (beside the change's builds, all
    at once) and load them; returns ``({source: CDLL}, {source: ptxas
    rows})``, or exits unless each speaks the C API of version 3."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = os.path.join(BUILD_DIR, f"lib{name}_parent.so")
        procs[name] = (out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", out,
             os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    threads = [threading.Thread(target=lambda n=n, p=p: logs.__setitem__(n, p.communicate()[0]))
               for n, (_, p) in procs.items()]
    for t in threads:
        t.start()
    build_all(list(SOURCES))
    for t in threads:
        t.join()
    libs, rows = {}, {}
    for name, (out, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{logs[name][-8000:]}")
        lib = ctypes.CDLL(out)
        version = (lib.megastep_abi_version() if hasattr(lib, "megastep_abi_version")
                   else 1)
        if version != 3:
            raise SystemExit(f"megastep_ab: the parent's megastep_launch ({name}.cu) is "
                             f"of version {version}; this tool launches version 3")
        libs[name], rows[name] = lib, ptxas_rows(logs[name])
    return libs, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="directory with the previous megastep.cu, megastep_wide.cu "
                         "and their headers")
    ap.add_argument("--order", default="change",
                    help="comma-separated versions (parent, change), timed in "
                         "this order at each shape")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("megastep_ab: needs the card")
    order = args.order.split(",")
    if not set(order) <= {"parent", "change"} or ("parent" in order) != bool(args.parent):
        raise SystemExit("megastep_ab: --order takes parent and change, parent "
                         "only with --parent")
    dev = torch.device("cuda")
    parent, parent_rows = load_parent(args.parent) if args.parent else (None, None)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def emit(obj):
        print(json.dumps(obj), flush=True)

    totals = {label: [0.0] * len(order) for label, *_ in LADDERS}
    for label, urdf, tips, kinds, terms, B, phases, fractions in LADDERS:
        model = RobotModel.from_urdf_file(asset_path(urdf), device=dev)
        cpu = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
        V, K = model.nvars, len(kinds)
        for N, steps in ladder(B, phases, fractions):
            sp = SpeciesParams(V=V, K=K)
            mega = Megastep(model, list(tips), list(range(V)), list(range(K)), sp, steps,
                            sec_terms=terms, inst_kind=list(kinds))
            state, consts, _ = megastep_inputs(cpu, list(tips), sp, steps, N,
                                               with_noise=False, sec_terms=terms,
                                               inst_kind=list(kinds))
            state, consts = tree_from_numpy(state, dev), tree_from_numpy(consts, dev)
            salt = torch.arange(N, dtype=torch.int32, device=dev)[None] // 2
            run = {"parent": lambda: parent_launch(parent, mega, state, consts, 99, salt),
                   "change": lambda: mega(state, consts, seed=99, salt=salt)}
            for i, version in enumerate(order):
                ms = cuda_ms(run[version], args.reps)
                totals[label][i] += ms
                emit({"ladder": label, "lanes": N, "n_steps": steps,
                      "version": version, "ms": ms, "gpu": gpu})
            del state, consts
            torch.cuda.empty_cache()
    emit({"summary": {label: [[v, ms] for v, ms in zip(order, t)]
                      for label, t in totals.items()},
          "note": "ms per ladder (the sum over its 4 launch shapes) of each "
                  "entry of --order, in turn", "gpu": gpu})
    for name in SOURCES:
        change = ptxas_table(name)
        out = {"ptxas": name, "change": change}
        if parent_rows:
            out["parent"] = parent_rows[name]
            old = {r["entry"]: r for r in parent_rows[name]}
            out["entries_that_differ"] = [r["entry"] for r in change
                                          if old.get(r["entry"]) != r]
        emit(out)


if __name__ == "__main__":
    main()
