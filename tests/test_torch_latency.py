"""The port's single-query entry points: latency mode (``solve_until``) on
the fused engine and on the island path, ``solve``/``search``, the routing
between the engine and the island path, the adaptive ladder's host
compaction, and the port's ``bench_latency`` (CPU, plain versions).

Port-only unless named: the fused ``solve_until`` is held bit for bit to
the engine's own batched solve at B = 1.  The slow test measures the JAX
island path and the port's on ``bench_latency``'s first 50 targets at its
budget — the island path's quality anchor (``PERF.md``).
"""

import json

import numpy as np
import pytest
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import (AdaptiveBatchSolver, IKResult, IKSolver, RobotModel,
                              SolverConfig, asset_path, make_fk)
from bio_ik_tpu_torch.engine import FusedBio2Engine
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.tools import bench_latency

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"


@pytest.fixture(scope="module")
def arm():
    return RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")


def _targets(m, n, seed=0, spread=None):
    """FK targets of ``n`` configurations: uniform in the bounds, or within
    ``spread`` rad of ``neutral_q()``."""
    rng = np.random.default_rng(seed)
    b = m._np_bounds
    if spread is None:
        q = rng.uniform(b["min"], b["max"], (n, m.nvars))
    else:
        q = np.clip(m.neutral_q() + rng.uniform(-spread, spread, (n, m.nvars)),
                    b["min"], b["max"])
    return make_fk(m, [TIP])(torch.as_tensor(q, dtype=torch.float32))


def _pose_data(s, m, tg, i):
    data = s.make_data(torch.as_tensor(m.neutral_q()))
    data["primary"][0]["position"] = tg.pos[i]
    data["primary"][0]["orientation"] = tg.quat[i]
    return data


def test_fused_solve_until_equals_solve_batch_bitwise(arm):
    """With an acceptance no query meets, ``solve_until`` runs every chunk
    and returns what ``_solve_batch`` returns for the same query at B = 1,
    bit for bit (the same chunk seeds and salt)."""
    s = IKSolver(arm, [G.PoseGoal(link=TIP)],
                 SolverConfig(dtwist=1e-12, max_steps=6, steps_per_check=2))
    assert s.engine is not None and s.engine.fullstep
    tg = _targets(arm, 1)
    data = _pose_data(s, arm, tg, 0)
    key = torch.tensor([3, 11])
    res, steps = s.engine.solve_until(key, data, max_checks=s.engine.nchecks)
    ref = s.engine._solve_batch(key[None], tree_map(lambda x: x[None], data))
    assert steps == 6 and not bool(res.success)
    for a, b in zip(res, ref):
        assert torch.equal(a, b[0])
    via_api = s.solve_until(torch.as_tensor(arm.neutral_q()), key=key, data=data)
    assert all(torch.equal(a, b) for a, b in zip(via_api, res))
    assert s.last_steps == 6


def test_solve_until_stops_early_on_an_easy_target(arm):
    """A target 0.05 rad from the seed is accepted within the first chunks:
    fewer steps than ``max_steps``, success, and the flag re-derived."""
    s = IKSolver(arm, [G.PoseGoal(link=TIP)],
                 SolverConfig(dtwist=1e-3, max_steps=64, steps_per_check=2))
    tg = _targets(arm, 1, spread=0.05)
    data = _pose_data(s, arm, tg, 0)
    res, steps = s.engine.solve_until(torch.tensor([0, 1]), data)
    assert bool(res.success) and steps < 64
    fk = make_fk(arm, [TIP])
    ok = s.problem.check_solution(fk(res.q[None]), res.qa[None],
                                  tree_map(lambda x: x[None], data))
    assert bool(ok[0])


def test_timeout_zero_runs_one_chunk(arm):
    s = IKSolver(arm, [G.PoseGoal(link=TIP)],
                 SolverConfig(dtwist=1e-12, max_steps=1 << 30, steps_per_check=2))
    tg = _targets(arm, 1)
    data = _pose_data(s, arm, tg, 0)
    _, steps = s.engine.solve_until(torch.tensor([0, 2]), data, timeout_s=0.0)
    assert steps == 2
    free = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    sf = IKSolver(free, [G.PositionGoal(link="tool")],
                  SolverConfig(dtwist=float("inf"), dpos=1e-9, max_steps=1 << 30,
                               steps_per_check=1))
    sf.solve_until(torch.as_tensor(free.neutral_q()), timeout_s=0.0)
    assert sf.last_steps == 1


def test_floating_chain_takes_the_island_branch(monkeypatch):
    """``free_arm`` has the species tier, not the megastep: ``solve_until``
    runs the island path (JAX api.py:430-456) and solves a near target; the
    engine's own ``solve_until`` refuses the species tier, as JAX's does."""
    m = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    s = IKSolver(m, [G.PositionGoal(link="tool")],
                 SolverConfig(dpos=5e-3, dtwist=float("inf"), max_steps=16,
                              steps_per_check=2))
    assert s.engine is not None and not s.engine.fullstep
    with pytest.raises(ValueError, match="megastep kernel tier"):
        s.engine.solve_until(torch.tensor([0, 0]), s.make_data(m.neutral_q()))
    calls = []
    orig = s._chunk
    monkeypatch.setattr(s, "_chunk", lambda *a: calls.append(1) or orig(*a))
    q = np.clip(m.neutral_q() + 0.2, m._np_bounds["min"], m._np_bounds["max"])
    data = s.make_data(torch.as_tensor(m.neutral_q()))
    data["primary"][0]["position"] = make_fk(m, ["tool"])(
        torch.as_tensor(q, dtype=torch.float32)).pos
    res = s.solve_until(torch.as_tensor(m.neutral_q()), key=[0, 4], data=data)
    assert bool(res.success) and len(calls) * 2 == s.last_steps <= 16
    assert res.q.shape == (m.nvars,)


def test_search_semantics(arm):
    """None for an unaccepted result unless ``return_approximate_solution``;
    the callback filters accepted results (JAX api.py:390-404)."""
    s = IKSolver(arm, [G.PoseGoal(link=TIP)],
                 SolverConfig(dtwist=1e-3, max_steps=4, steps_per_check=4))
    seed = torch.as_tensor(arm.neutral_q())
    easy = _pose_data(s, arm, _targets(arm, 1, spread=0.02), 0)
    far = _pose_data(s, arm, _targets(arm, 1, seed=5), 0)
    res = s.search(seed, data=easy)
    assert isinstance(res, IKResult) and bool(res.success)
    assert s.search(seed, data=easy, solution_callback=lambda r: False) is None
    seen = []
    assert s.search(seed, data=easy, solution_callback=lambda r: seen.append(r) or True) \
        is not None and len(seen) == 1
    assert s.search(seed, data=far) is None
    approx = s.search(seed, data=far, return_approximate_solution=True)
    assert approx is not None and not bool(approx.success)
    assert torch.equal(approx.q, s.solve(seed, data=far).q)


def _on_card(iksolver):
    iksolver.problem.device = torch.device("cuda")     # metadata only
    return FusedBio2Engine.shared_reason(iksolver), FusedBio2Engine.card_reason(iksolver)


def test_supports_splits_shared_and_card_reasons(arm):
    """The JAX engine's reasons (mode, goal kinds) send a problem to the
    island path on both packages; a kernel block that does not fit in the
    card's shared memory is the card's alone, and ``supports`` is the first
    of the two."""
    reg = [G.PoseGoal(link=TIP), G.MinimalDisplacementGoal(weight=0.1)]
    s = IKSolver(arm, reg, SolverConfig(mode="bio2"))
    assert _on_card(s) == (None, None)
    snake = RobotModel.from_urdf_file(asset_path("snake.urdf"), device="cpu")
    fixed = IKSolver(snake, [G.PositionGoal(link="head")], fixed_joints=[snake.joint_names[2]])
    assert _on_card(fixed) == (None, None)
    free = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    gap = IKSolver(free, [G.PositionGoal(link="tool")] * 4)
    shared, card = _on_card(gap)
    assert shared is None and "233472 bytes" in card and "shared memory" in card
    assert FusedBio2Engine.supports(gap) == card
    look_free = IKSolver(RobotModel.from_urdf_file(asset_path("free_arm.urdf"),
                                                   device="cpu"),
                         [G.LookAtGoal(link="tool")])
    shared, _ = _on_card(look_free)
    assert "fullstep kernel" in shared
    assert look_free.engine is None and not look_free.kernel_gap
    off = IKSolver(arm, [G.PoseGoal(link=TIP)], SolverConfig(fused="off"))
    assert off.engine is None and not off.kernel_gap and "fused='off'" in off.unsupported


def test_kernel_gaps_raise_instead_of_the_island_path(arm, monkeypatch):
    """A problem whose only gap is the card's (its kernel block does not
    fit in shared memory) raises from ``solve_batch``; ``solve_until``
    raises on a fullstep chain and takes the island branch on a
    species-tier chain (as JAX's does for every species-tier chain);
    ``solve`` runs the island path for every problem."""
    def gap(iksolver):
        return "no group size fits in the card's 232448 bytes of shared memory"

    monkeypatch.setattr(FusedBio2Engine, "card_reason", staticmethod(gap))
    s = IKSolver(arm, [G.PoseGoal(link=TIP)], SolverConfig(max_steps=2, steps_per_check=2))
    assert s.engine is None and s.kernel_gap
    data = tree_map(lambda x: x[None], s.make_data(arm.neutral_q()))
    with pytest.raises(NotImplementedError, match="232448 bytes"):
        s.solve_batch(torch.tensor([[0, 1]]), data)
    with pytest.raises(NotImplementedError, match="232448 bytes"):
        s.solve_until(arm.neutral_q())
    assert s.solve(arm.neutral_q()).q.shape == (arm.nvars,)
    free = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    sf = IKSolver(free, [G.PositionGoal(link="tool")],
                  SolverConfig(dtwist=float("inf"), max_steps=2, steps_per_check=2))
    assert sf.kernel_gap and not sf.fullstep_chain
    assert sf.solve_until(free.neutral_q()).q.shape == (free.nvars,)
    with pytest.raises(NotImplementedError, match="232448 bytes"):
        AdaptiveBatchSolver(arm, [G.PoseGoal(link=TIP)], phases=((1, 2), (2, 2))
                            ).solve_batch(torch.tensor([[0, 1]]), data)


def test_host_compaction_ladder_with_fused_off(arm):
    """``fused="off"``: every phase is the island path, failures compacted on
    the host (JAX api.py:126-163): a retry is adopted only where it succeeds
    or fits better, and the phases' successes only grow."""
    B = 6
    tg = _targets(arm, B, seed=3)
    ab = AdaptiveBatchSolver(arm, [G.PoseGoal(link=TIP)],
                             SolverConfig(dtwist=1e-3, fused="off"),
                             phases=((1, 2), (2, 4)), chunk_fraction=0.5)
    assert all(s.engine is None for s in ab.solvers)
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                    ab.make_data(torch.as_tensor(arm.neutral_q())))
    data["primary"][0]["position"] = tg.pos
    data["primary"][0]["orientation"] = tg.quat
    keys = torch.stack([torch.zeros(B, dtype=torch.int64), torch.arange(B)], -1)
    first = ab.solvers[0].solve_batch(keys, data)
    res = ab.solve_batch(keys, data)
    assert res.q.shape == (B, arm.nvars)
    assert bool((res.fitness <= first.fitness).all())
    assert bool((res.success | ~first.success).all())
    kept = first.success
    assert torch.equal(res.q[kept], first.q[kept])


def test_bench_latency_rows_on_the_cpu(arm, capsys):
    """``bench_latency``'s rows at two queries, on the plain versions: the
    JAX tool's keys, and on the CPU no megastep launches."""
    m, _, tg = bench_latency.setup("cpu", n=2)
    r = bench_latency.run_setting(m, tg, 8, 16)
    assert {"steps_per_check", "max_steps", "p50_ms", "p90_ms", "p99_ms",
            "success_rate", "n"} <= set(r) and r["n"] == 2
    assert r["megastep_launches_per_query"] == 0 and 1 <= r["chunks_per_query"] <= 2
    d = bench_latency.run_deadline(m, tg, 0.0, spc=4)
    assert d["chunks_per_query"] == 1 and {"deadline_ms", "success_at_deadline"} <= set(d)
    i = bench_latency.run_island(m, tg, n=1, max_steps=2)
    assert i["islands"] == 4 and i["n"] == 1 and np.isfinite(i["median_pos_err_m"])
    b = bench_latency.run_island_batch(m, tg, n=2, max_steps=2)
    assert b["n"] == 2 and 0 <= b["success_rate"] <= 1 and np.isfinite(b["median_pos_err_m"])
    json.dumps([r, d, i, b])


# ---------------------------------------------------------------------------
# the island path's quality anchor: the JAX package and the port on
# bench_latency's first 50 targets at its budget (max_steps 64, 4 islands)

N_ISLAND, ISLAND_STEPS = 50, 64


@pytest.mark.slow
def test_island_solve_matches_jax_on_bench_latency_targets():
    """``IKSolver.solve`` of both packages on the first 50 of
    ``bench_latency``'s targets (PR2, PoseGoal, dtwist 1e-3, max_steps 64,
    4 islands, keys ``PRNGKey(i)``): the port's success within 0.1 of the
    JAX package's.  Prints both rows (about an hour on a CPU: the JAX
    island step takes ~0.3 s per island)."""
    import jax
    import jax.numpy as jnp

    import bio_ik_tpu.goals as JG
    from bio_ik_tpu import RobotModel as JRobotModel
    from bio_ik_tpu.api import IKSolver as JIKSolver
    from bio_ik_tpu.config import SolverConfig as JSolverConfig
    from bio_ik_tpu.kinematics import make_fk as j_make_fk

    jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    b = jm._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(N_ISLAND, jm.nvars)).astype(np.float32)
    jtg = j_make_fk(jm, [TIP])(jnp.asarray(qg))
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)],
                   JSolverConfig(mode="bio2_memetic", dtwist=1e-3, max_steps=ISLAND_STEPS))
    jseed = jnp.asarray(jm.neutral_q())
    jdata = js.make_data(jseed)
    jok, jerr = 0, []
    for i in range(N_ISLAND):
        jdata["primary"][0]["position"] = jtg.pos[i]
        jdata["primary"][0]["orientation"] = jtg.quat[i]
        r = js.solve(jseed, key=jax.random.PRNGKey(i), data=jdata)
        jok += bool(r.success)
        jerr.append(float(np.linalg.norm(
            np.asarray(j_make_fk(jm, [TIP])(r.q[None]).pos)[0, 0] - np.asarray(jtg.pos)[i, 0])))
    m, _, tg = bench_latency.setup("cpu", n=N_ISLAND)
    port = bench_latency.run_island(m, tg, n=N_ISLAND, max_steps=ISLAND_STEPS)
    jax_row = {"success_rate": jok / N_ISLAND, "median_pos_err_m": float(np.median(jerr)),
               "n": N_ISLAND, "max_steps": ISLAND_STEPS}
    print(json.dumps({"jax_island": jax_row, "port_island": port}))
    assert abs(port["success_rate"] - jax_row["success_rate"]) <= 0.1
