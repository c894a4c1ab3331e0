#!/usr/bin/env python
"""Multi-config benchmark suite, through the port.

The port's copy of ``tools/bench_suite.py``: the same 12 rows in the same
order — URDFs, tips, goals, ``SolverConfig``s, phases, fractions,
tolerances and batch caps — and the same targets (FK of
``numpy.random.default_rng(0)`` uniform draws in the bounds, seeded at
``neutral_q()``), run through ``bio_ik_tpu_torch`` (no JAX) on the card.
Each row is one JSON line with the JAX tool's keys plus ``launches`` (the
megastep or species kernel launches of one ``solve_batch``) and ``device``
(the card's name and power limit, ``nvidia-smi``).  ``engine`` is
``fused`` where every phase runs the fused engine, else ``island`` (the
JAX tool's ``vmap``).

The batch is ``BENCH_BATCH`` (default 2048), capped per row as in the JAX
tool.  The solve keys come from an explicit ``torch.Generator`` seeded 0
(the JAX tool splits ``PRNGKey(0)``; the port carries no threefry); the
timed loop — one warm-up, then the best of three ``solve_batch`` calls on
the same keys, each ended by a synchronization — copies nothing between
host and device.

Usage: ``python -m bio_ik_tpu_torch.tools.bench_suite`` (on the card;
``--rows ur5_pose,kuka_iiwa_pose`` selects rows, ``--device cpu`` runs the
plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import (AdaptiveBatchSolver, IKSolver, RobotModel, SolverConfig,
                              asset_path, make_fk)
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel
from bio_ik_tpu_torch.tools.bench import device_name

DEFAULT_PHASES = ((1, 8), (2, 32), (4, 64))
ARM, DUAL_L, HUM = "r_gripper_tool_frame", "l_gripper_tool_frame", ("r_hand", "l_hand", "head")

# name → run_config's arguments (JAX tools/bench_suite.py:109-229); ``cap``
# is the JAX tool's ``batch=min(B, cap)``
ROWS = {
    "pr2_arm_pose": dict(
        urdf="pr2_arm.urdf", tips=[ARM], goals=[G.PoseGoal(link=ARM)],
        cfg=SolverConfig(mode="bio2_memetic", dtwist=1e-3), pos_tol=1e-3),
    "ur5_pose": dict(
        urdf="ur5.urdf", tips=["tool0"], goals=[G.PoseGoal(link="tool0")],
        cfg=SolverConfig(mode="bio2_memetic", dtwist=1e-3), pos_tol=1e-3,
        phases=((1, 8), (2, 32), (4, 64), (8, 64)), fractions=(0.75, 0.25, 0.02)),
    "pr2_dual_pose2": dict(
        urdf="pr2_dual.urdf", tips=[ARM, DUAL_L],
        goals=[G.PoseGoal(link=ARM), G.PoseGoal(link=DUAL_L)],
        cfg=SolverConfig(mode="bio2_memetic", dtwist=1e-3), pos_tol=1e-3,
        phases=((1, 64), (2, 64), (4, 128), (8, 128)), fractions=(0.25, 0.08, 0.03)),
    "snake32_position": dict(
        urdf="snake.urdf", tips=["head"], goals=[G.PositionGoal(link="head")],
        cfg=SolverConfig(mode="bio2_memetic", dpos=5e-3, dtwist=float("inf"),
                         max_steps=16),
        pos_tol=5e-3, adaptive=False),
    "free_arm_floating_base": dict(
        urdf="free_arm.urdf", tips=["tool"], goals=[G.PositionGoal(link="tool")],
        cfg=SolverConfig(mode="bio2_memetic", dpos=5e-3, dtwist=float("inf"),
                         max_steps=16),
        pos_tol=5e-3, cap=1024, adaptive=False),
    "ur5_pose_bio1": dict(
        urdf="ur5.urdf", tips=["tool0"], goals=[G.PoseGoal(link="tool0")],
        cfg=SolverConfig(mode="bio1", dtwist=1e-3, max_steps=32),
        pos_tol=1e-3, cap=512, adaptive=False),
    "ur5_pose_gd4": dict(
        urdf="ur5.urdf", tips=["tool0"], goals=[G.PoseGoal(link="tool0")],
        cfg=SolverConfig(mode="gd_4", dtwist=1e-3, max_steps=64),
        pos_tol=1e-3, cap=512, adaptive=False),
    "kuka_iiwa_pose": dict(
        urdf="kuka_iiwa.urdf", tips=["tool0"], goals=[G.PoseGoal(link="tool0")],
        cfg=SolverConfig(mode="bio2_memetic", dtwist=1e-3), pos_tol=1e-3),
    "humanoid_whole_body": dict(
        urdf="humanoid.urdf", tips=list(HUM), goals=[G.PoseGoal(link=t) for t in HUM],
        cfg=SolverConfig(mode="bio2_memetic", dpos=1e-2, dtwist=float("inf")),
        pos_tol=1e-2, cap=1024, phases=((1, 32), (2, 64), (4, 128), (8, 128))),
    "humanoid_whole_body_mm": dict(
        urdf="humanoid.urdf", tips=list(HUM), goals=[G.PoseGoal(link=t) for t in HUM],
        cfg=SolverConfig(mode="bio2_memetic", dpos=1e-3, dtwist=float("inf")),
        pos_tol=1e-3, cap=1024,
        phases=((1, 32), (2, 64), (4, 128), (8, 256), (8, 256), (8, 256)),
        fractions=(0.75, 0.3, 0.2, 0.15, 0.12)),
    "pr2_arm_pose_regularized": dict(
        urdf="pr2_arm.urdf", tips=[ARM],
        goals=[G.PoseGoal(link=ARM), G.MinimalDisplacementGoal(weight=0.05),
               G.AvoidJointLimitsGoal(weight=0.05)],
        cfg=SolverConfig(mode="bio2_memetic", dtwist=1e-3), pos_tol=1e-3,
        phases=((1, 32), (2, 64), (4, 128), (8, 256)), fractions=(0.3, 0.1, 0.03)),
    "pr2_dual_multigoal": dict(
        urdf="pr2_dual.urdf", tips=[ARM, DUAL_L],
        goals=[G.PoseGoal(link=ARM),
               G.LookAtGoal(link=DUAL_L, axis=(1.0, 0.0, 0.0), target=(1.0, 0.0, 0.5),
                            weight=0.5),
               G.MinimalDisplacementGoal(weight=0.2), G.AvoidJointLimitsGoal(weight=0.2)],
        cfg=SolverConfig(mode="bio2_memetic", dpos=1e-2, drot=float("inf"),
                         dtwist=float("inf")),
        pos_tol=1e-2, cap=1024, phases=((1, 32), (2, 32), (4, 64), (8, 128)),
        fractions=(0.3, 0.1, 0.04)),
}


def default_batch() -> int:
    return int(os.environ.get("BENCH_BATCH", "2048"))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_config(name, urdf, tips, goals, cfg, pos_tol, batch=None, adaptive=True,
               phases=DEFAULT_PHASES, fractions=None, device="cuda") -> dict:
    """One row (JAX ``run_config``): prints its JSON line and returns it."""
    batch = batch or default_batch()
    dev = torch.device(device)
    m = RobotModel.from_urdf_file(asset_path(urdf), device=dev)
    fk = make_fk(m, tips)
    b = m._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(batch, m.nvars)).astype(np.float32)
    tg = fk(torch.as_tensor(qg, device=dev))

    if adaptive:
        s = AdaptiveBatchSolver(m, goals, cfg, phases=phases, fractions=fractions)
        fused = all(x.engine is not None for x in s.solvers)
    else:
        s = IKSolver(m, goals, cfg)
        fused = s.engine is not None
    data = tree_map(lambda x: x.expand((batch,) + x.shape).clone(),
                    s.make_data(torch.as_tensor(m.neutral_q(), device=dev)))
    pos_slots = []
    for i, grp in enumerate(s.problem.primary):
        if grp.goal_type not in ("position", "pose"):
            continue
        for k in range(grp.count):
            slot = int(grp.tip_slots[k])
            pos_slots.append(slot)
            if "position" in data["primary"][i]:
                data["primary"][i]["position"][:, k] = tg.pos[:, slot]
            if "orientation" in data["primary"][i]:
                data["primary"][i]["orientation"][:, k] = tg.quat[:, slot]
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 1 << 32, (batch, 2), generator=gen, dtype=torch.int64).to(dev)

    res = s.solve_batch(keys, data)                   # build + warm-up
    _sync(dev)
    Megastep.launches = SpeciesKernel.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = s.solve_batch(keys, data)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    launches = (Megastep.launches + SpeciesKernel.launches) // 3
    dt = min(times)

    slots = sorted(set(pos_slots))
    perr = (fk(res.q).pos[:, slots] - tg.pos[:, slots]).norm(dim=-1).amax(-1)
    success = float(res.success.float().mean())
    solved = float((perr < pos_tol).float().mean())
    row = {
        "config": name,
        "solves_per_sec": round(batch * success / dt, 1),
        "success_rate": round(success, 4),
        f"frac_pos_err<{pos_tol}": round(solved, 4),
        "median_pos_err_m": float(perr.median()),
        "batch": batch,
        "batch_time_ms": round(dt * 1e3, 2),
        "dof": m.nvars,
        "engine": "fused" if fused else "island",
        "launches": launches,
        "device": device_name(dev),
    }
    print(json.dumps(row), flush=True)
    return row


def run_row(name, batch=None, device="cuda") -> dict:
    """Row ``name`` of :data:`ROWS` at ``batch`` (default ``BENCH_BATCH``,
    capped as the row says)."""
    kw = dict(ROWS[name])
    cap = kw.pop("cap", None)
    B = batch or default_batch()
    return run_config(name, batch=min(B, cap) if cap else B, device=device, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated rows (default: all 12, in order)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_suite: no CUDA device (pass --device cpu)")
    rows = args.rows.split(",")
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        raise SystemExit(f"bench_suite: unknown rows {unknown}; known: {list(ROWS)}")
    for name in rows:
        run_row(name, device=args.device)


if __name__ == "__main__":
    main()
