#!/usr/bin/env python
"""Benchmark: scenario-batched IK solves/sec on the PR2 7-DOF pose problem,
through the port.

The port's copy of ``bench.py``: the same configuration and the same JSON
keys, run through ``bio_ik_tpu_torch`` (no JAX) on the card —
``bio2_memetic`` on ``pr2_arm.urdf``, one PoseGoal on
``r_gripper_tool_frame``, 1 mm tolerance (``dtwist = 1e-3``), B =
``BENCH_BATCH`` (65 536) targets from FK of ``numpy.random.default_rng(0)``
uniform draws in the bounds, seeded at ``neutral_q()``,
``AdaptiveBatchSolver`` with phases ``(1,24),(2,32),(4,64),(8,32)`` and
fractions ``(0.15,0.03,0.008)``; ``BENCH_QUEUE`` (16) batches queued with
fresh keys and one synchronisation, best of 3.

``value`` counts only successful solves (B · success rate / batch time);
a retry's result is adopted with its own success flag
(``AdaptiveBatchSolver._take``), so a retry that fits better but fails
does not count.  ``vs_baseline`` is against the reference's ~1 000
solves/s on one CPU core.  ``device`` is the card's name and power limit
(``nvidia-smi``).

Usage: ``python -m bio_ik_tpu_torch.tools.bench`` (on the card;
``--device cpu`` runs the plain versions, for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import AdaptiveBatchSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.engine import fold_in
from bio_ik_tpu_torch.interop import tree_map

REFERENCE_SOLVES_PER_SEC = 1000.0
TIP = "r_gripper_tool_frame"
PHASES = ((1, 24), (2, 32), (4, 64), (8, 32))
FRACTIONS = (0.15, 0.03, 0.008)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    the torch device."""
    if dev.type != "cuda":
        return str(dev)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def run(batch: int = None, queue: int = None, repeats: int = 3, device="cuda") -> dict:
    """One benchmark run; returns bench.py's JSON object."""
    B = batch or int(os.environ.get("BENCH_BATCH", "65536"))
    K = queue or int(os.environ.get("BENCH_QUEUE", "16"))
    dev = torch.device(device)
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=dev)
    fk = make_fk(m, [TIP])
    b = m._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(B, m.nvars)).astype(np.float32)
    tg = fk(torch.as_tensor(qg, device=dev))
    s = AdaptiveBatchSolver(m, [G.PoseGoal(link=TIP)],
                            SolverConfig(mode="bio2_memetic", dtwist=1e-3),
                            phases=PHASES, fractions=FRACTIONS)
    data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q())))
    data["primary"][0]["position"] = tg.pos.contiguous()
    data["primary"][0]["orientation"] = tg.quat.contiguous()
    keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                        torch.arange(B, dtype=torch.int64)], -1).to(dev)

    res = s.solve_batch(keys, data)                   # build + warm-up
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for r in range(K):
            res = s.solve_batch(fold_in(keys, r), data)
        _sync(dev)
        times.append((time.perf_counter() - t0) / K)
    dt = min(times)
    success = float(res.success.float().mean())
    perr = (fk(res.q).pos[:, 0] - tg.pos[:, 0]).norm(dim=-1)
    solves_per_sec = B * success / dt
    return {
        "metric": "IK solves/sec (PR2 7-DOF pose, 1mm tol, bio2_memetic)",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / REFERENCE_SOLVES_PER_SEC, 3),
        "success_rate": round(success, 4),
        "batch": B,
        "phases": ",".join(f"{i}x{n}" for i, n in PHASES) + " adaptive",
        "batch_time_ms": round(dt * 1e3, 2),
        "median_pos_err_m": float(perr.median()),
        "note": "PyTorch/CUDA port (bio_ik_tpu_torch), hand-written megastep kernel",
        "device": device_name(dev),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu for the plain versions)")
    print(json.dumps(run(device=args.device)), flush=True)


if __name__ == "__main__":
    main()
