#!/usr/bin/env python
"""The sharded solves of :mod:`bio_ik_tpu_torch.parallel` against the
single-card ones, in a world of one and a world of two.

bench.py's problem — ``bio2_memetic`` on ``pr2_arm.urdf``, one PoseGoal on
``r_gripper_tool_frame`` at ``dtwist = 1e-3``, targets from FK of
``numpy.random.default_rng(0)`` draws in the bounds, seeded at
``neutral_q()`` — through a plain :class:`IKSolver`:

  * :func:`world_one` — one process, its own process group (NCCL on the
    card, gloo on the CPU): the batch-sharded solve of B queries bitwise
    ``solve_batch``; the island-sharded solve of ``queries`` single
    queries on the fused engine, without migration bitwise the single
    query (``solve_batch`` at B = 1 with key ``fold_in(key, 0)``, rank
    0's key), and with migration; the island path's sharded solve
    (``fused="off"``) bitwise ``IKSolver.solve``;
  * :func:`world_two` — two spawned processes in a gloo group on one
    device (NCCL refuses two ranks on one card): the batch-sharded result
    bitwise the two halves' ``solve_batch`` (made in this process), and
    the island-sharded solve with migration the same on both ranks and
    better than the seed.

Each row carries its megastep launches and milliseconds; a failed
equivalence raises.  Usage: ``python -m
bio_ik_tpu_torch.tools.parallel_check`` (on the card; ``--device cpu``
runs the plain versions at a small size).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.engine import fold_in
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
from bio_ik_tpu_torch.parallel.distributed import initialize_distributed
from bio_ik_tpu_torch.parallel.islands import (default_mesh, make_sharded_batch_solve,
                                               make_sharded_island_solve)

TIP = "r_gripper_tool_frame"
# the two-process world's start-up, solves and gathers together
WORLD_TWO_TIMEOUT_S = 600


def free_address() -> str:
    """``127.0.0.1:<port>`` of a port free just now (the group's store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class BenchProblem:
    """bench.py's problem on ``device`` for ``B`` targets; ``config`` keyword
    arguments go to its :class:`SolverConfig`."""

    def __init__(self, device, B: int, **config):
        self.dev = torch.device(device)
        self.model = m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=self.dev)
        self.fk = make_fk(m, [TIP])
        b = m._np_bounds
        qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                              size=(B, m.nvars)).astype(np.float32)
        self.tg = self.fk(torch.as_tensor(qg, device=self.dev))
        self.solver = self.solver_with(**config)
        self.data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                             self.solver.make_data(torch.as_tensor(m.neutral_q())))
        self.data["primary"][0]["position"] = self.tg.pos.contiguous()
        self.data["primary"][0]["orientation"] = self.tg.quat.contiguous()
        self.keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                                 torch.arange(B, dtype=torch.int64)], -1).to(self.dev)

    def solver_with(self, **config) -> IKSolver:
        """The problem's solver with ``config`` changed."""
        return IKSolver(self.model, [G.PoseGoal(link=TIP)],
                        SolverConfig(mode="bio2_memetic", dtwist=1e-3, **config))

    def query(self, i: int):
        """Query ``i``'s key and unbatched data."""
        return self.keys[i], tree_map(lambda x: x[i], self.data)

    def seed_fitness(self, data) -> float:
        return float(self.solver.ctx.fitness_exact(data["seed_active"], data))


def _timed(dev, fn, *args):
    """``(fn(*args), megastep launches, ms)``, the device synchronized."""
    Megastep.launches = 0
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(dev)
    return out, Megastep.launches, (time.perf_counter() - t0) * 1e3


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _rows_world_one(device, B, queries, max_steps, query_steps, island_steps):
    rows = []
    p = BenchProblem(device, B, max_steps=max_steps)
    s, dev = p.solver, p.dev
    batch = make_sharded_batch_solve(s, default_mesh("data", device=device))
    s.solve_batch(p.keys, p.data)                     # build + warm-up
    batch(p.keys, p.data)                             # the group's first collectives
    got, launches, ms = _timed(dev, batch, p.keys, p.data)
    ref, _, ref_ms = _timed(dev, s.solve_batch, p.keys, p.data)
    rows.append({"row": "batch_sharded", "batch": B, "steps": max_steps,
                 "launches": launches, "ms": ms, "solve_batch_ms": ref_ms,
                 "bitwise_solve_batch": _equal(got, ref),
                 "success_rate": float(got.success.float().mean())})
    mesh = default_mesh("islands", device=device)
    s = p.solver_with(max_steps=query_steps)
    for migrate in (False, True):
        solve = make_sharded_island_solve(s, mesh, migrate=migrate)
        ok, bitwise, launches, ms = [], [], [], []
        for i in range(queries):
            key, data = p.query(i)
            res, n, t = _timed(dev, solve, key, data)
            ok.append(bool(res.success))
            launches.append(n)
            ms.append(t)
            if not migrate:
                single = s.solve_batch(fold_in(key[None], 0), tree_map(lambda x: x[None], data))
                bitwise.append(_equal(res, tree_map(lambda x: x[0], single)))
        row = {"row": "island_sharded_fused", "migrate": migrate, "queries": queries,
               "steps": query_steps, "success_rate": float(np.mean(ok)),
               "launches_per_query": float(np.mean(launches)),
               "ms_per_query": float(np.median(ms))}
        if not migrate:
            row["bitwise_single_query"] = all(bitwise)
        rows.append(row)
    s = p.solver_with(fused="off", max_steps=island_steps)
    key, data = p.query(0)
    single = s.solve(data["seed_full"], key=fold_in(key[None], 0)[0], data=data)
    res, launches, ms = _timed(dev, make_sharded_island_solve(s, mesh), key, data)
    rows.append({"row": "island_sharded_island_path", "steps": island_steps,
                 "launches": launches, "ms": ms, "bitwise_single_query": _equal(res, single),
                 "success": bool(res.success)})
    return rows


def world_one(device="cuda", B=65536, queries=8, max_steps=16, query_steps=64,
              island_steps=4):
    """The world-of-one rows (see the module docstring): the batch at
    ``max_steps`` steps, the single queries at ``query_steps`` (latency
    mode's budget), the island path at ``island_steps``; the process group
    is made and destroyed here.  Raises where an equivalence fails."""
    initialize_distributed(free_address(), 1, 0, device=device)
    try:
        rows = _rows_world_one(device, B, queries, max_steps, query_steps, island_steps)
    finally:
        dist.destroy_process_group()
    bad = [r for r in rows if not r.get("bitwise_solve_batch", True)
           or not r.get("bitwise_single_query", True)]
    if bad:
        raise AssertionError(f"a sharded solve differs from the single-card one: {bad}")
    return rows


def _rank_main(rank, address, device, B, max_steps, out_dir):
    """One rank of :func:`world_two`: a gloo group (``device="cpu"`` to
    :func:`initialize_distributed`) whose solves run on ``device``; saves
    its results to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    initialize_distributed(address, 2, rank, device="cpu")
    try:
        p = BenchProblem(device, B, max_steps=max_steps)
        batch = make_sharded_batch_solve(p.solver, default_mesh("data", device=device))
        batch(p.keys, p.data)                         # warm-up: build, first collectives
        res, launches, ms = _timed(p.dev, batch, p.keys, p.data)
        key, data = p.query(0)
        isl = make_sharded_island_solve(p.solver, default_mesh("islands", device=device),
                                        migrate=True)
        isl(key, data)
        mig, mig_launches, mig_ms = _timed(p.dev, isl, key, data)
        torch.save({"batch": [x.cpu() for x in res], "launches": launches, "ms": ms,
                    "island": [x.cpu() for x in mig], "island_launches": mig_launches,
                    "island_ms": mig_ms},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world_two(device="cuda", B=8192, max_steps=16, timeout_s=WORLD_TWO_TIMEOUT_S):
    """The world-of-two rows (see the module docstring): two spawned ranks,
    every process ended here.  Raises where an equivalence fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_rank_main, args=(free_address(), device, B, max_steps,
                                                   out_dir),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(1.0, t0 + timeout_s - time.perf_counter())):
                if time.perf_counter() > t0 + timeout_s:
                    raise TimeoutError(f"the two ranks ran over {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        wall = time.perf_counter() - t0
        out = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
               for r in range(2)]
    p = BenchProblem(device, B, max_steps=max_steps)
    s, h = p.solver, B // 2
    halves = [s.solve_batch(p.keys[r * h:(r + 1) * h],
                            tree_map(lambda x: x[r * h:(r + 1) * h], p.data)) for r in range(2)]
    ref = [torch.cat([a, b]).cpu() for a, b in zip(*halves)]
    key, data = p.query(0)
    isl = [o["island"] for o in out]
    rows = [{"row": "batch_sharded", "world": 2, "backend": "gloo", "batch": B,
             "launches_by_rank": [o["launches"] for o in out],
             "ms_by_rank": [o["ms"] for o in out],
             "bitwise_halves_solve_batch": all(_equal(o["batch"], ref) for o in out),
             "success_rate": float(ref[1].float().mean())},
            {"row": "island_sharded_fused", "world": 2, "backend": "gloo", "migrate": True,
             "launches_by_rank": [o["island_launches"] for o in out],
             "ms_by_rank": [o["island_ms"] for o in out],
             "same_on_both_ranks": _equal(isl[0], isl[1]),
             "fitness": float(isl[0][2]), "seed_fitness": p.seed_fitness(data),
             "success": bool(isl[0][1]), "wall_s": wall}]
    if not (rows[0]["bitwise_halves_solve_batch"] and rows[1]["same_on_both_ranks"]
            and rows[1]["fitness"] < rows[1]["seed_fitness"]):
        raise AssertionError(f"the two-rank sharded solves fail their checks: {rows}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("parallel_check: no CUDA device (pass --device cpu)")
    kw = {} if args.device == "cuda" else dict(B=8, queries=2, max_steps=4, query_steps=4)
    for row in world_one(args.device, **kw):
        print(json.dumps(row), flush=True)
    kw = {} if args.device == "cuda" else dict(B=8, max_steps=4)
    for row in world_two(args.device, **kw):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
