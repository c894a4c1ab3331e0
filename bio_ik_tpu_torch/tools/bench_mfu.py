#!/usr/bin/env python
"""Arithmetic-efficiency data point for the megastep kernel on the card.

The port of ``tools/bench_mfu.py``.  Three measurements:

  1. an empirical FP32 peak — the dependent-chain kernel of
     ``csrc/peak.cu`` (:mod:`bio_ik_tpu_torch.kernels.peak`): eight chaotic
     logistic-map chains per element of a ``(256, 512·16)`` float32 array,
     3 FLOPs per iteration; the rate is the slope between 1 024 and 4 096
     iterations (CUDA events), which cancels launch overhead;
  2. the megastep's useful-FLOP throughput — the TPU cost model's FLOPs
     per step and lane (``bio2_megastep.megastep_flops_per_lane``) over the
     marginal chunk time: a 64-step solve (4 launches of 16 steps) minus a
     16-step solve (1 launch), over 3, at B = 32 768 on the PR2 arm;
  3. their ratio, and the megastep's rate as a share of the data sheet's
     FP32 peak.

The peak kernel issues one FP32 instruction per FLOP (a multiply, a
subtract, a multiply, not fused), so it reaches at most half the
FMA-counted data-sheet figure.  The megastep's FLOP count leaves out the
Philox generator, selection and bookkeeping, so the ratio is a lower bound
on how busy the card is.  Prints one JSON line.

Usage: ``python -m bio_ik_tpu_torch.tools.bench_mfu`` (on the card).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import megastep_flops_per_lane
from bio_ik_tpu_torch.kernels.peak import PeakChains, peak_flops

TIP = "r_gripper_tool_frame"
PEAK_R, PEAK_W, PEAK_G = 256, 512, 16
PEAK_T = (1024, 4096)
B_MFU = 32768
SPC = 16
# FP32 peak of the H100 SXM data sheet, an FMA counted as two FLOPs
FP32_DATASHEET_FLOPS = 67e12


def _event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def vpu_peak_flops():
    """Sustained FP32 rate of the dependent-chain kernel: ``(flops/s,
    ms at each T)``, the slope between the two iteration counts."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0.2, 0.8, size=(PEAK_R, PEAK_W * PEAK_G)).astype(np.float32),
        device="cuda")
    kern = PeakChains()

    def timed(T):
        kern(x, T, PEAK_W)
        torch.cuda.synchronize()
        return min(_event_ms(lambda: kern(x, T, PEAK_W), 1) for _ in range(4))

    ms = {T: timed(T) for T in PEAK_T}
    flops = peak_flops(PEAK_R, PEAK_W * PEAK_G, PEAK_T[1] - PEAK_T[0])
    return flops / ((ms[PEAK_T[1]] - ms[PEAK_T[0]]) * 1e-3), ms


def measure(steps, m, tg, B):
    """Best of 3 × (8 queued solves) of a ``steps``-step solve, seconds."""
    cfg = SolverConfig(mode="bio2_memetic", dtwist=1e-3, max_steps=steps,
                       steps_per_check=SPC)
    s = IKSolver(m, [G.PoseGoal(link=TIP)], cfg)
    assert s.engine is not None and s.engine.fullstep
    data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q())))
    data["primary"][0]["position"] = tg.pos.contiguous()
    data["primary"][0]["orientation"] = tg.quat.contiguous()
    keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                        torch.arange(B, dtype=torch.int64)], -1).to(m.device)

    s.solve_batch(keys, data)
    torch.cuda.synchronize()
    K = 8
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K):
            s.solve_batch(keys, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / K)
    return min(times), s.engine


def smi_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def run(B=B_MFU):
    """The three measurements as one dict (the JSON line's fields)."""
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    b = m._np_bounds
    qg = np.random.default_rng(0).uniform(
        b["min"], b["max"], size=(B, m.nvars)).astype(np.float32)
    tg = make_fk(m, [TIP])(torch.as_tensor(qg, device=m.device))

    peak, peak_ms = vpu_peak_flops()
    # marginal chunk cost: 64-step solve (4 megastep launches) minus the
    # 16-step solve (1 launch) = 3 × (16-step launch + acceptance check)
    t16, eng = measure(SPC, m, tg, B)
    t64, _ = measure(4 * SPC, m, tg, B)
    chunk = (t64 - t16) / 3.0
    lanes = B * eng.islands * 2
    fl = megastep_flops_per_lane(eng.sp, SPC) * lanes
    ach = fl / chunk
    return {
        "config": "megastep_mfu_pr2",
        "vpu_fma_peak_tflops": peak / 1e12,
        "peak_ms_by_iterations": {str(k): v for k, v in peak_ms.items()},
        "kernel_chunk_ms": chunk * 1e3,
        "solve_ms": {"16_steps": t16 * 1e3, "64_steps": t64 * 1e3},
        "useful_flops_per_chunk": fl,
        "achieved_useful_tflops": ach / 1e12,
        "fraction_of_vpu_peak": ach / peak,
        "fraction_of_fp32_datasheet_peak": ach / FP32_DATASHEET_FLOPS,
        "lanes": lanes,
        "note": "chunk includes the acceptance check; Philox/selection ops "
                "are not counted as useful FLOPs — the ratio is a lower "
                "bound; the peak kernel issues 3 unfused FP32 instructions "
                "per 3 FLOPs (at most half the FMA-counted data-sheet peak)",
        "device": smi_line(),
    }


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
