#!/usr/bin/env python
"""Single-query latency benchmark (latency mode, ``solve_until``), through
the port.

The port's copy of ``tools/bench_latency.py``: its setting and its JSON
keys, run through ``bio_ik_tpu_torch`` (no JAX).  The reference's own
published metric is per-query wall-clock latency (reference:
README.md:74-101 — 1 ms recommended for a 6-7 DOF arm, 5 ms per PR2 arm
group, 20 ms whole-body).  Here: ``IKSolver.solve_until`` (host-polled
early exit, the analog of the reference's first-success-cancels-the-rest
race, ik_parallel.h:160-190) on PR2 7-DOF pose queries at ``dtwist = 1e-3``
— ``r_gripper_tool_frame``, ``BENCH_QUERIES`` (200) targets from FK of
``numpy.random.default_rng(0)`` uniform draws in the bounds, seeded at
``neutral_q()``:

  * ``run_setting`` — p50/p90/p99 per query at ``(steps_per_check,
    max_steps)`` ∈ {(4,64), (8,64), (16,64), (32,64)};
  * ``run_fused_single`` — ``solve_batch`` at B = 1 (all chunks of a
    query without a host check), and 64 queued queries' time each;
  * ``run_deadline`` — a wall-clock ``timeout_s`` of 1 / 5 / 20 ms;
  * ``run_deadline_device`` — each deadline turned into the device-step
    budget the fused single query fits into it, at islands = 32;
  * ``run_island`` — ``IKSolver.solve`` (the island path) per query, and
    ``run_island_batch`` — the island path on 50 targets in one batch;
  * ``run_breakdown`` — a ``solve_until`` query split into its prep, its
    megastep launches and the glue around them.

On the card each row also counts megastep launches per query; ``device``
is the card's name and power limit (``nvidia-smi``).

Usage: ``python -m bio_ik_tpu_torch.tools.bench_latency`` (on the card;
``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
from bio_ik_tpu_torch.tools.bench import device_name

TIP = "r_gripper_tool_frame"
SETTINGS = ((4, 64), (8, 64), (16, 64), (32, 64))
DEADLINES_S = (1e-3, 5e-3, 20e-3)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def n_queries() -> int:
    return int(os.environ.get("BENCH_QUERIES", "200"))


def setup(device="cuda", n=None):
    """The PR2 model, its FK and the targets: ``(model, fk, tg)`` with
    ``tg.pos (n, 1, 3)``, ``tg.quat (n, 1, 4)``."""
    n = n or n_queries()
    dev = torch.device(device)
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=dev)
    fk = make_fk(m, [TIP])
    b = m._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(n, m.nvars)).astype(np.float32)
    return m, fk, fk(torch.as_tensor(qg, device=dev))


def _solver(m, **cfg):
    return IKSolver(m, [G.PoseGoal(link=TIP)],
                    SolverConfig(mode="bio2_memetic", dtwist=1e-3, **cfg))


def _fused(m, **cfg):
    """:func:`_solver` on the fused engine (raises where there is none)."""
    s = _solver(m, **cfg)
    if s.engine is None:
        raise RuntimeError(f"no fused engine: {s.unsupported}")
    return s


def _keys(dev, n):
    """``jax.random.PRNGKey(i)``'s words for i < n, on the device."""
    return torch.stack([torch.zeros(n, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64)], -1).to(dev)


def _query(data, tg, i):
    """``data`` with query i's target (a fresh dict; the rest shared)."""
    d = dict(data)
    d["primary"] = [dict(data["primary"][0])]
    d["primary"][0]["position"] = tg.pos[i]
    d["primary"][0]["orientation"] = tg.quat[i]
    return d


def _pct(lat_ms):
    lat = np.asarray(lat_ms)
    return {f"p{q}_ms": float(np.percentile(lat, q)) for q in (50, 90, 99)}


def run_setting(m, tg, spc, max_steps, n=None, islands=0):
    """``solve_until`` per query at one ``(steps_per_check, max_steps)``."""
    n = n or tg.pos.shape[0]
    dev = m.device
    s = _solver(m, max_steps=max_steps, steps_per_check=spc, islands=islands)
    seed = torch.as_tensor(m.neutral_q(), device=dev)
    data = s.make_data(seed)
    keys = _keys(dev, n)
    s.solve_until(seed, key=keys[0], data=_query(data, tg, 0))   # warm-up
    lat, ok, chunks = [], 0, []
    launches0 = Megastep.launches
    for i in range(n):
        d = _query(data, tg, i)
        t0 = time.perf_counter()
        res = s.solve_until(seed, key=keys[i], data=d)
        good = bool(res.success)                                  # sync
        lat.append((time.perf_counter() - t0) * 1e3)
        ok += good
        chunks.append(s.last_steps // s.spc)
    return {"steps_per_check": spc, "max_steps": max_steps, **_pct(lat),
            "success_rate": ok / n, "n": n,
            "chunks_per_query": float(np.mean(chunks)),
            "megastep_launches_per_query": (Megastep.launches - launches0) / n}


def run_fused_single(m, tg, max_steps=64, spc=16, n=None, queue=64):
    """A query as ``solve_batch`` at B = 1: every chunk of it without a host
    check.  Also ``queue`` queries dispatched back to back with one
    synchronization: the per-query time without the host's wait."""
    n = n or tg.pos.shape[0]
    dev = m.device
    s = _fused(m, max_steps=max_steps, steps_per_check=spc)
    data = tree_map(lambda x: x[None], s.make_data(torch.as_tensor(m.neutral_q(),
                                                                   device=dev)))
    keys = _keys(dev, max(n, queue))
    tq = tg._replace(pos=tg.pos[:, None], quat=tg.quat[:, None])
    s.solve_batch(keys[:1], _query(data, tq, 0)).q.cpu()           # warm-up
    lat, ok = [], 0
    launches0 = Megastep.launches
    for i in range(n):
        d = _query(data, tq, i)
        t0 = time.perf_counter()
        r = s.solve_batch(keys[i:i + 1], d)
        good = bool(r.success[0])                                 # sync
        lat.append((time.perf_counter() - t0) * 1e3)
        ok += good
    launches = (Megastep.launches - launches0) / n
    d = _query(data, tq, 0)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(queue):
        r = s.solve_batch(keys[i:i + 1], d)
    _sync(dev)
    queued_ms = (time.perf_counter() - t0) / queue * 1e3
    return {**_pct(lat), "queued_per_query_ms": queued_ms, "success_rate": ok / n,
            "n": n, "megastep_launches_per_query": launches}


def run_deadline(m, tg, timeout_s, spc=8, n=None):
    """Wall-clock deadline mode (``solve_until(timeout_s=...)``): chunks of
    ``steps_per_check`` run until acceptance or the deadline; the returned
    solution is the best accepted so far (reference: README.md:74-101,
    kinematics_plugin.cpp:506-507)."""
    n = n or tg.pos.shape[0]
    dev = m.device
    s = _solver(m, max_steps=1 << 30, steps_per_check=spc)
    seed = torch.as_tensor(m.neutral_q(), device=dev)
    data = s.make_data(seed)
    keys = _keys(dev, n)
    s.solve_until(seed, key=keys[0], data=_query(data, tg, 0), timeout_s=timeout_s)
    lat, ok, chunks = [], 0, []
    for i in range(n):
        d = _query(data, tg, i)
        t0 = time.perf_counter()
        res = s.solve_until(seed, key=keys[i], data=d, timeout_s=timeout_s)
        good = bool(res.success)
        lat.append((time.perf_counter() - t0) * 1e3)
        ok += good
        chunks.append(s.last_steps // s.spc)
    p = _pct(lat)
    return {"deadline_ms": timeout_s * 1e3, "steps_per_check": spc,
            "p50_ms": p["p50_ms"], "p99_ms": p["p99_ms"],
            "success_at_deadline": ok / n, "n": n,
            "chunks_per_query": float(np.mean(chunks))}


def _device_ms(s, data, keys, K=16):
    """Device time per query of ``K`` queued ``solve_batch`` queries: on the
    card the kernels' busy time (``torch.profiler``: what the device
    computes, without the host's eager prep and glue around it), on the
    CPU the host clock (the plain versions are the device work there)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = keys.device
    s.solve_batch(keys[:1], data).q.cpu()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(K):
            s.solve_batch(keys[i:i + 1], data).q.cpu()
        return (time.perf_counter() - t0) / K * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(K):
            s.solve_batch(keys[i:i + 1], data)
        _sync(dev)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) or 0.0
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return busy_us / K / 1e3


def run_deadline_device(m, tg, deadlines_s=DEADLINES_S, spc=8, islands=32, n=None):
    """Deadline → device-step budget: the fused single query's per-step
    device time from the slope of its device time between two budgets (the
    fixed per-query part cancels), each deadline turned into the step
    budget that fits in it on the device, and success at that budget over
    the queries (``solve_batch`` at B = 1).  The JAX tool takes the queued
    time, which on the TPU is the one program's device time; here a query's
    host prep and glue do not overlap its kernels, so the device time is
    the kernels' busy time (:func:`_device_ms`), and ``run_deadline``'s
    rows keep the host's cost.  Queries race ``islands`` islands (the
    reference racing its solver on all threads, ik_parallel.h:110-139)."""
    n = n or tg.pos.shape[0]
    dev = m.device
    tq = tg._replace(pos=tg.pos[:, None], quat=tg.quat[:, None])
    keys = _keys(dev, max(n, 16))

    def build(max_steps):
        s = _fused(m, islands=islands, max_steps=max_steps, steps_per_check=spc)
        data = tree_map(lambda x: x[None], s.make_data(
            torch.as_tensor(m.neutral_q(), device=dev)))
        return s, _query(data, tq, 0)

    ms_lo = _device_ms(*build(2 * spc), keys)
    ms_hi = _device_ms(*build(8 * spc), keys)
    step_ms = max((ms_hi - ms_lo) / (6 * spc), 1e-4)
    fixed_ms = max(ms_lo - 2 * spc * step_ms, 0.0)
    out = []
    for t in deadlines_s:
        budget = int((t * 1e3 - fixed_ms) / step_ms)
        n_steps = max(spc, (budget // spc) * spc)
        s, data = build(n_steps)
        s.solve_batch(keys[:1], data).q.cpu()
        ok = 0
        for i in range(n):
            r = s.solve_batch(keys[i:i + 1], _query(data, tq, i))
            ok += bool(r.success[0])
        out.append({"deadline_ms": t * 1e3, "device_step_budget": n_steps,
                    "per_step_device_us": step_ms * 1e3, "fixed_program_ms": fixed_ms,
                    "success_at_deadline": ok / n, "n": n, "islands": islands})
    return out


def run_island(m, tg, n=50, max_steps=64):
    """``IKSolver.solve`` — the island path — on the first ``n`` targets:
    success, median position error and time per query."""
    n = min(n, tg.pos.shape[0])
    dev = m.device
    s = _solver(m, max_steps=max_steps)
    seed = torch.as_tensor(m.neutral_q(), device=dev)
    data = s.make_data(seed)
    keys = _keys(dev, n)
    fk = make_fk(m, [TIP])
    lat, ok, err = [], 0, []
    for i in range(n):
        d = _query(data, tg, i)
        t0 = time.perf_counter()
        res = s.solve(seed, key=keys[i], data=d)
        good = bool(res.success)
        lat.append((time.perf_counter() - t0) * 1e3)
        ok += good
        err.append(float((fk(res.q).pos[0] - tg.pos[i, 0]).norm()))
    return {"max_steps": max_steps, "islands": s.islands, "success_rate": ok / n,
            "median_pos_err_m": float(np.median(err)), "ms_per_query": float(np.mean(lat)),
            **_pct(lat), "n": n}


def run_island_batch(m, tg, n=50, max_steps=64):
    """The island path on the first ``n`` targets at once: ``solve_batch``
    with ``fused="off"`` (the code ``solve`` runs, B = n, one random stream
    for the batch) — success and median position error at the budget of
    :func:`run_island`, in one pass of n × islands rows."""
    n = min(n, tg.pos.shape[0])
    dev = m.device
    s = _solver(m, max_steps=max_steps, fused="off")
    data = tree_map(lambda x: x.expand((n,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q(), device=dev)))
    data["primary"][0]["position"] = tg.pos[:n].contiguous()
    data["primary"][0]["orientation"] = tg.quat[:n].contiguous()
    t0 = time.perf_counter()
    res = s.solve_batch(_keys(dev, n), data)
    ok = res.success.float().mean().item()
    seconds = time.perf_counter() - t0
    err = (make_fk(m, [TIP])(res.q).pos[:, 0] - tg.pos[:n, 0]).norm(dim=-1)
    return {"max_steps": max_steps, "islands": s.islands, "success_rate": ok,
            "median_pos_err_m": float(err.median()), "seconds": seconds, "n": n}


def run_breakdown(m, tg, spc=4, max_steps=64, n=None):
    """Where a ``solve_until`` query's time goes (fused tier, the card
    synchronized between parts, so the parts add up to more than an
    unsynchronized query): ``prep`` (``_mega_prep``: lane layout, goal
    rows, the seed's FK and fitness), ``kernel`` (the megastep launches,
    CUDA events), ``glue`` (the winner and merge after each launch, the
    host check, the result)."""
    n = n or tg.pos.shape[0]
    dev = m.device
    s = _solver(m, max_steps=max_steps, steps_per_check=spc)
    eng = s.engine
    seed = torch.as_tensor(m.neutral_q(), device=dev)
    data = s.make_data(seed)
    keys = _keys(dev, n)
    cuda = dev.type == "cuda"
    s.solve_until(seed, key=keys[0], data=_query(data, tg, 0))
    tot = {"prep_ms": 0.0, "kernel_ms": 0.0, "glue_ms": 0.0, "query_ms": 0.0}
    for i in range(n):
        d = tree_map(lambda x: x[None], _query(data, tg, i))
        _sync(dev)
        t0 = time.perf_counter()
        state, consts, salt, best = eng._mega_prep(keys[i:i + 1], d)
        _sync(dev)
        t1 = time.perf_counter()
        kern = 0.0
        for c in range(eng.nchecks):
            tk = time.perf_counter()
            if cuda:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ev0.record()
            state = eng._mega_once(c, salt, state, consts)
            if cuda:
                ev1.record()
                ev1.synchronize()
                kern += ev0.elapsed_time(ev1)
            else:
                kern += (time.perf_counter() - tk) * 1e3
            best = eng._merge(best, eng._eval_lanes(state[3], state[4], state[5], d))
            if bool(best[2][0]):
                break
        eng._result(best, d).q.cpu()
        t2 = time.perf_counter()
        tot["prep_ms"] += (t1 - t0) * 1e3
        tot["kernel_ms"] += kern
        tot["glue_ms"] += (t2 - t1) * 1e3 - kern
        tot["query_ms"] += (t2 - t0) * 1e3
    out = {k: v / n for k, v in tot.items()}
    out.update({k.replace("_ms", "_share"): out[k] / out["query_ms"]
                for k in ("prep_ms", "kernel_ms", "glue_ms")},
               steps_per_check=spc, max_steps=max_steps, n=n)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_latency: no CUDA device (pass --device cpu for the "
                         "plain versions)")
    m, _, tg = setup(args.device)
    dev_name = device_name(m.device)

    def emit(config, row):
        print(json.dumps({"config": config, **row, "device": dev_name}), flush=True)

    results = []
    for spc, max_steps in SETTINGS:
        r = run_setting(m, tg, spc, max_steps)
        results.append(r)
        emit("pr2_arm_pose_latency_solve_until", r)
    emit("pr2_arm_pose_latency_solve_until_best", min(results, key=lambda r: r["p50_ms"]))
    emit("pr2_arm_pose_latency_fused_single_dispatch",
         {**run_fused_single(m, tg), "reference_recommendation_ms": 1.0})
    for r in run_deadline_device(m, tg):
        emit("pr2_arm_pose_latency_deadline_device", r)
    for t in DEADLINES_S:
        emit("pr2_arm_pose_latency_deadline_wall", run_deadline(m, tg, t))
    emit("pr2_arm_pose_latency_island_solve", run_island(m, tg))
    emit("pr2_arm_pose_latency_island_batch", run_island_batch(m, tg))
    emit("pr2_arm_pose_latency_breakdown", run_breakdown(m, tg))


if __name__ == "__main__":
    main()
