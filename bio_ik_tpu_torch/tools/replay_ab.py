#!/usr/bin/env python
"""Eager against replayed on the card: single-query ``IKSolver.solve`` and
``solve_until`` of the island path's modes that replay CUDA graphs.

For each mode (default ``bio1``, ``gd_4``, ``optlib_lbfgs``): a solver on the
PR2 arm with a ``PoseGoal`` at 1 mm (``dtwist`` 1e-3), ``--steps`` steps
(``steps_per_check`` 4), neutral seeds, targets from ``default_rng(42)`` in
the arm's bounds as Table B's.  Versions, each on a fresh ``IKSolver``, in
the order given:

  * ``replayed`` — as the port runs (``graphs.Replay``): the first calls
    of each function run eagerly, the next captures its graph, later calls
    and later solves replay it;
  * ``eager`` — every ``Replay`` calls its function.

Each version runs, per target, one ``solve`` and one ``solve_until`` (the
card synchronized, wall clock); the first target's pair is the cold one,
in which a replayed version captures its graphs.  Prints one JSON line per
(mode, version) — ms of every call, graph replays a call, success — and per
mode whether the two versions' solutions are bitwise equal.

Usage (on the card)::

    python -m bio_ik_tpu_torch.tools.replay_ab --modes bio1,gd_4,optlib_lbfgs \\
        --targets 3 --order replayed,eager
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _smi():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_version(mode, version, steps, targets, device="cuda"):
    """``targets`` solves and solve_untils of ``mode`` in ``version`` on
    ``device``: their ms, replays and solutions."""
    import numpy as np
    import torch
    import bio_ik_tpu_torch.goals as G
    from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
    from bio_ik_tpu_torch.graphs import Replay

    tip = "r_gripper_tool_frame"
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device=device)
    b = m._np_bounds
    qg = np.random.default_rng(42).uniform(b["min"], b["max"], (targets, m.nvars))
    tg = make_fk(m, [tip])(torch.as_tensor(qg.astype(np.float32), device=device))
    s = IKSolver(m, [G.PoseGoal(link=tip)], SolverConfig(
        mode=mode, dtwist=1e-3, max_steps=steps, steps_per_check=4))
    seed = torch.as_tensor(m.neutral_q(), device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    replay = Replay.__call__
    if version == "eager":
        Replay.__call__ = lambda self, *a: self.fn(*a)
    out = {"solve_ms": [], "solve_until_ms": [], "replays": [], "success": [],
           "until_steps": [], "q": []}
    try:
        for i in range(targets):
            data = s.make_data(seed)
            data["primary"][0]["position"] = tg.pos[i]
            data["primary"][0]["orientation"] = tg.quat[i]
            for call in ("solve", "solve_until"):
                before = Replay.replays
                sync()
                t0 = time.perf_counter()
                res = getattr(s, call)(seed, key=[0, i], data=data)
                sync()
                out[call + "_ms"].append((time.perf_counter() - t0) * 1e3)
                out["replays"].append(Replay.replays - before)
                out["success"].append(bool(res.success))
                out["q"].append(res.q.detach().cpu())
            out["until_steps"].append(s.last_steps)
    finally:
        Replay.__call__ = replay
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="bio1,gd_4,optlib_lbfgs")
    ap.add_argument("--order", default="replayed,eager")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--targets", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("replay_ab: needs an NVIDIA card")
    print(json.dumps({"gpu": _smi()}), flush=True)
    for mode in args.modes.split(","):
        qs = {}
        for version in args.order.split(","):
            r = run_version(mode, version, args.steps, args.targets)
            qs.setdefault(version, r.pop("q"))
            print(json.dumps({"mode": mode, "version": version, "steps": args.steps, **r}),
                  flush=True)
        first = next(iter(qs.values()))
        print(json.dumps({"mode": mode, "bitwise_equal": all(
            all(torch.equal(a, b) for a, b in zip(first, q)) for q in qs.values())}),
              flush=True)


if __name__ == "__main__":
    main()
