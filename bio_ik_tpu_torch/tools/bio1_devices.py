#!/usr/bin/env python
"""bio1 on the card against bio1 on the CPU, on Table B's PR2 row.

Table B (BENCHMARKS.md:157-168; tools/parity_rates.py:89-112): 64 PR2
targets, FK of ``numpy.random.default_rng(42)`` uniform draws in the
bounds, ``neutral_q`` seeds, ``dtwist = 1e-3``, 64 steps in one check,
bio1's default 4 islands; ``linear_fitness`` optional.  Three measurements
split a difference of the card's success from the CPU's into its causes:

  * ``fk_norms`` — the squared norm of the FK quaternions at the targets'
    configurations minus 1 on each device, and the shortest angle a
    quaternion makes with itself by ``quat_angle_shortest(q, q)`` (the
    arccos of a dot clamped at 1: 0 where the norm exceeds 1);
  * ``stream`` — ``IKSolver.solve_batch`` on the device with its own random
    stream, ``seeds`` key words × 64 targets in one batch: the success of
    each key word's 64 rows and of all of them;
  * ``shared_draws`` — the island solve run in lockstep on the CPU and on
    the device from one initial state with the same draws each step (drawn
    on the CPU by ``Bio1Solver.draw_step``): the largest difference of the
    two populations after each of the first steps and the share of them
    within 1e-4, the rows whose solutions end within 1e-4, and each
    device's success.

Prints one JSON object per measurement, and one with every result as the
last line.  Usage: ``python -m bio_ik_tpu_torch.tools.bio1_devices
[--device cuda] [--seeds 4] [--steps 64] [--dtype float32]
[--linear 0|1] [--angle atan2|arccos]``; ``--n`` cuts the targets,
``--device cpu`` runs both sides on the CPU; ``--angle arccos`` gives bio1
the JAX package's rotation angle (``quat_angle_shortest``, the arccos of
the quaternions' dot) in place of its own (``quat_angle_atan2``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.engine import FusedBio2Engine
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.math.quat import quat_angle_shortest
from bio_ik_tpu_torch.solvers import bio1
from bio_ik_tpu_torch.solvers.bio1 import Bio1Draws, Bio1State
from bio_ik_tpu_torch.tools.bench import device_name

TIP = "r_gripper_tool_frame"
N_TARGETS = 64
KEY_WORD = 7          # chip_smoke.py's unfused rows: keys (7, b)


def setup(device, n=N_TARGETS):
    """The PR2 model on ``device`` and Table B's first ``n`` targets from
    that device's FK: ``(model, tg)``."""
    dev = torch.device(device)
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=dev)
    b = m._np_bounds
    qg = np.random.default_rng(42).uniform(b["min"], b["max"], (N_TARGETS, m.nvars))[:n]
    tg = make_fk(m, [TIP])(torch.as_tensor(qg.astype(np.float32), device=dev))
    return m, tg


def solver(m, steps, dtype="float32", linear=False):
    return IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
        mode="bio1", dtwist=1e-3, max_steps=steps, steps_per_check=steps,
        dtype=dtype, linear_fitness=linear))


def batch(s, m, tg, seeds):
    """``(keys, data)`` of ``seeds`` key words × the targets, key word
    major."""
    n = tg.pos.shape[0]
    B = n * seeds
    dt = s.problem.tdtype
    data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q(), device=m.device)))
    data["primary"][0]["position"] = tg.pos.to(dt).repeat(seeds, 1, 1).contiguous()
    data["primary"][0]["orientation"] = tg.quat.to(dt).repeat(seeds, 1, 1).contiguous()
    keys = torch.stack([torch.arange(seeds).repeat_interleave(n) + KEY_WORD,
                        torch.arange(n).repeat(seeds)], -1).to(m.device)
    return keys, data


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fk_norms(device):
    """FK quaternion norms at Table B's configurations on ``device`` and on
    the CPU, and the self-angle floor of bio1's rotation term."""
    out = {}
    for dev in dict.fromkeys(["cpu", device]):
        _, tg = setup(dev)
        q = tg.quat[:, 0].double()
        n2 = (q * q).sum(-1) - 1.0
        ang = quat_angle_shortest(tg.quat, tg.quat)[:, 0].double()
        out[str(dev)] = {"norm2_minus_1_mean": float(n2.mean()),
                         "norm2_minus_1_min": float(n2.min()),
                         "norm2_minus_1_max": float(n2.max()),
                         "frac_norm_below_1": float((n2 < 0).double().mean()),
                         "self_angle_max_rad": float(ang.max()),
                         "self_angle_mean_rad": float(ang.mean()),
                         "frac_self_angle_nonzero": float((ang > 0).double().mean())}
    return out


def stream(device, seeds, steps, dtype="float32", linear=False, n=N_TARGETS):
    """``solve_batch`` on ``device`` with its own random stream."""
    m, tg = setup(device, n)
    s = solver(m, steps, dtype, linear)
    keys, data = batch(s, m, tg, seeds)
    _sync(m.device)
    t0 = time.perf_counter()
    res = s.solve_batch(keys, data)
    ok = res.success.reshape(seeds, -1).double().cpu()
    _sync(m.device)
    return {"device": str(m.device), "dtype": dtype, "linear_fitness": linear,
            "steps": steps, "n": int(ok.numel()), "success_rate": float(ok.mean()),
            "success_by_key_word": ok.mean(-1).tolist(),
            "seconds": time.perf_counter() - t0}


def shared_draws(device, steps, dtype="float32", linear=False, n=N_TARGETS,
                 detail_steps=4):
    """The island solve in lockstep on the CPU and on ``device``, the CPU's
    initial state and draws fed to both."""
    mc, tgc = setup("cpu", n)
    md = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=torch.device(device))
    sc, sd = solver(mc, steps, dtype, linear), solver(md, steps, dtype, linear)
    keys, data_c = batch(sc, mc, tgc, 1)
    dev = md.device
    move = lambda x: None if x is None else x.to(dev)  # noqa: E731
    data_d = tree_map(move, data_c)
    st_c, best_c, dr_c = sc._init_islands(keys, data_c)
    st_d = Bio1State(sd._generator(keys.to(dev)), *(move(x) for x in st_c[1:]))
    dr_d = tree_map(move, dr_c)
    best_d = sd._eval_islands(st_d, data_d, dr_d)
    R = st_c.genes.shape[0]
    detail = []
    for k in range(steps):
        draws = sc.solver.draw_step(st_c.generator, R)
        st_c = sc.solver.step(st_c, dr_c, draws)
        st_d = sd.solver.step(st_d, dr_d, Bio1Draws(*(move(x) for x in draws)))
        if k < detail_steps:
            gd = st_d.genes.cpu().double()
            gc = st_c.genes.double()
            same = torch.isclose(gd, gc, rtol=0, atol=1e-4).all(-1)
            detail.append({"step": k + 1,
                           "max_abs_genes_diff": float((gd - gc).abs().max()),
                           "max_abs_fitness_diff": float(
                               (st_d.fitness.cpu().double() - st_c.fitness.double()).abs().max()),
                           "frac_individuals_within_1e-4": float(same.double().mean()),
                           "frac_rows_all_within_1e-4": float(same.all(-1).double().mean())})
    best_c = FusedBio2Engine._merge(best_c, sc._eval_islands(st_c, data_c, dr_c))
    best_d = FusedBio2Engine._merge(best_d, sd._eval_islands(st_d, data_d, dr_d))
    sol = (st_d.solution.cpu().double() - st_c.solution.double()).abs().amax(-1)
    return {"device": str(dev), "dtype": dtype, "linear_fitness": linear, "steps": steps,
            "n": n, "first_steps": detail,
            "frac_rows_solution_within_1e-4": float((sol <= 1e-4).double().mean()),
            "success_rate_cpu": float(best_c[2].double().mean()),
            "success_rate_device": float(best_d[2].double().cpu().mean())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--linear", type=int, default=1)
    ap.add_argument("--n", type=int, default=N_TARGETS)
    ap.add_argument("--angle", default="atan2", choices=("arccos", "atan2"),
                    help="bio1's rotation angle: its own (quat_angle_atan2) or "
                         "the JAX package's (quat_angle_shortest)")
    ap.add_argument("--only", default="fk_norms,stream,stream_cpu,shared_draws")
    a = ap.parse_args(argv)
    only = a.only.split(",")
    lin = bool(a.linear)
    res = {"gpu": device_name(torch.device(a.device)), "angle": a.angle}
    if a.angle == "arccos":
        bio1.quat_angle_atan2 = quat_angle_shortest
    if "fk_norms" in only:
        res["fk_norms"] = fk_norms(a.device)
        print(json.dumps({"fk_norms": res["fk_norms"]}), flush=True)
    if "stream" in only:
        res["stream"] = stream(a.device, a.seeds, a.steps, a.dtype, lin, a.n)
        print(json.dumps({"stream": res["stream"]}), flush=True)
    if "stream_cpu" in only and a.device != "cpu":
        res["stream_cpu"] = stream("cpu", a.seeds, a.steps, a.dtype, lin, a.n)
        print(json.dumps({"stream_cpu": res["stream_cpu"]}), flush=True)
    if "shared_draws" in only:
        res["shared_draws"] = shared_draws(a.device, a.steps, a.dtype, lin, a.n)
        print(json.dumps({"shared_draws": res["shared_draws"]}), flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
