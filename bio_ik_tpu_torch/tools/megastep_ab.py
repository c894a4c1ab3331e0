#!/usr/bin/env python
"""A/B timing of the megastep kernel on the card, at the 8 launch shapes
of the retry ladders.

The shapes are ``chip_smoke.py``'s: bench.py's main ladder (pose-only
kernel; 131 072 / 39 320 / 15 728 / 8 384 lanes at 24 / 32 / 64 / 32
steps) and the regularized ladder (the secondary-goal kernel with the
MinimalDisplacement and AvoidJointLimits terms; 131 072 / 78 640 /
52 424 / 31 456 lanes at 32 / 64 / 128 / 256 steps), PR2 arm, in-kernel
Philox, inputs from ``kernels/checks.megastep_inputs``.  Versions, timed
with CUDA events in one process on one card, in the order given:

  * ``change`` — ``csrc/megastep.cu`` through ``Megastep`` at the group
    size the wrapper chooses;
  * ``parent`` — the previous version of the source, from ``--parent DIR``
    holding its ``megastep.cu`` and headers.  It is launched through the
    C API of version 2 (``megastep_abi_version() == 2``: the argument list
    before the goal kinds' ``gaux``, ``inst_kind``, ``cols`` and ``ncol``,
    at the group size the wrapper's rule picks from the parent build's
    occupancy); a build of another version is refused, as its list
    differs.

Prints one JSON line per (shape, version), a summary line, and both
builds' ``-Xptxas -v`` rows (registers, stack, spill per kernel).  The
parent source is a measuring aid only: nothing on a solve path loads it.

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

import torch

from bio_ik_tpu_torch import RobotModel, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_megastep import (Megastep, _MEMETIC_CODE,
                                                    _ptr, choose_group)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.build import (BUILD_DIR, NVCC_FLAGS, _nvcc, build_all,
                                            ptxas_rows, ptxas_table)
from bio_ik_tpu_torch.kernels.checks import megastep_inputs

TIP = "r_gripper_tool_frame"
B = 65536
MAIN = ((1, 24), (2, 32), (4, 64), (8, 32)), (0.15, 0.03, 0.008)
REG = ((1, 32), (2, 64), (4, 128), (8, 256)), (0.3, 0.1, 0.03)
REG_TERMS = ("beta", "gamma")


def ladder(phases, fractions):
    """(lanes, n_steps) of a ladder's four launches (chip_smoke.phase_shapes)."""
    out = []
    for i, (islands, steps) in enumerate(phases):
        b = B if i == 0 else max(1, int(B * fractions[i - 1]))
        out.append((b * islands * 2, steps))
    return out


def parent_launch(lib, mega, state, consts, seed, salt):
    """One launch of the parent's megastep (C API version 2) on the same
    state, at the group size the wrapper chooses from the parent's
    occupancy."""
    sp = mega.sp
    dev = state[0].device
    N = state[0].shape[-1]
    if not hasattr(mega, "parent_group"):
        mega.parent_group = choose_group(N, {g: mega.resident_blocks(lib, dev, g)
                                             for g in mega.groups if sp.C % g == 0}, sp.C)
    G = mega.parent_group
    chain_i, chain_f, tip_slot, inst_tip = mega._chain_on(dev)[:4]
    out = tuple(torch.empty_like(t) for t in state)
    sec = consts[10] if mega.sec_terms else state[0]
    unread = state[0]
    fn = lib.megastep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                                         ctypes.c_uint] + [ctypes.c_void_p] * 34)
    rc = fn(sp.V, sp.K, mega.T, G, N, chain_i.shape[0], mega.nbranch, mega.n_steps,
            sp.gens, sp.C, sp.mem_iters, _MEMETIC_CODE[sp.memetic], sp.h, 1, seed,
            mega.sec_mask, _ptr(salt), *(_ptr(t) for t in state),
            *(_ptr(t) for t in out), *(_ptr(t) for t in consts[:10]), _ptr(sec),
            *([_ptr(unread)] * 5), _ptr(chain_i), _ptr(chain_f), _ptr(tip_slot),
            _ptr(inst_tip), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
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
    """Build the parent's ``megastep.cu`` (alongside the change's build) and
    load it; returns ``(CDLL, ptxas rows)``, or exits unless it speaks the
    C API of version 2."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libmegastep_parent.so")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", out,
                             os.path.join(src_dir, "megastep.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_all(["megastep"])
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent source:\n{log[-8000:]}")
    lib = ctypes.CDLL(out)
    version = lib.megastep_abi_version() if hasattr(lib, "megastep_abi_version") else 1
    if version != 2:
        raise SystemExit(f"megastep_ab: the parent's megastep_launch is of version "
                         f"{version}; this tool launches version 2")
    return lib, ptxas_rows(log)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="directory with the previous megastep.cu and sec_eval.cuh")
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
    model = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=dev)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def emit(obj):
        print(json.dumps(obj), flush=True)

    totals = {"main": [0.0] * len(order), "regularized": [0.0] * len(order)}
    for label, (phases, fractions), terms in (("main", MAIN, ()),
                                             ("regularized", REG, REG_TERMS)):
        for N, steps in ladder(phases, fractions):
            sp = SpeciesParams(V=7, K=1)
            mega = Megastep(model, [TIP], list(range(7)), [0], sp, steps,
                            sec_terms=terms)
            state, consts, _ = megastep_inputs(model, TIP, sp, steps, N,
                                               with_noise=False, sec_terms=terms)
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
    emit({"ptxas": "megastep", "change": ptxas_table("megastep"), "parent": parent_rows})


if __name__ == "__main__":
    main()
