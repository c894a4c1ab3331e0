"""The port's fused engine and adaptive batch API against the JAX package
(CPU).

Lane layout (``_mega_prep``), goal rows, the lane winner reduction and the
merge are held to the JAX engine's on the same data — taken from the JAX
package's ``make_data`` and carried across with ``interop`` — run eagerly.
The JAX engine is built through ``IKSolver(..., SolverConfig(fused="auto"))``
on the CPU, where construction compiles nothing.  The whole slice then runs
end to end on the CPU through the port's ``AdaptiveBatchSolver`` and is
checked with the JAX package's own fitness and acceptance test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bio_ik_tpu.goals as JG
from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.api import IKSolver as JIKSolver
from bio_ik_tpu.config import SolverConfig as JSolverConfig
from bio_ik_tpu.kinematics import make_fk as j_make_fk
from bio_ik_tpu.math import Frame as JFrame

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import (AdaptiveBatchSolver, IKResult, IKSolver,
                              RobotModel, SolverConfig, make_fk)
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map, tree_to_numpy

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
B = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def arms():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


def _batch(jsolver, jm, targets_q):
    """JAX data for B scenarios with pose targets at FK(targets_q)."""
    tg = j_make_fk(jm, [TIP])(jnp.asarray(targets_q))
    d0 = jsolver.make_data(jnp.asarray(jm.neutral_q()))
    data = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(targets_q),) + x.shape), d0)
    data["primary"][0]["position"] = tg.pos
    data["primary"][0]["orientation"] = tg.quat
    return data


@pytest.fixture(scope="module")
def solvers(arms):
    """The JAX and the port's fused solvers of one PoseGoal, two islands."""
    jm, tm = arms
    cfg = dict(mode="bio2_memetic", dtwist=1e-3, islands=2, max_steps=4,
               steps_per_check=4)
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)], JSolverConfig(fused="auto", **cfg))
    ts = IKSolver(tm, [G.PoseGoal(link=TIP)], SolverConfig(**cfg))
    assert js.engine is not None and ts.engine is not None
    return js, ts


def test_mega_prep_matches_jax(arms, solvers, rng):
    jm, tm = arms
    js, ts = solvers
    q = rng.uniform(tm._np_bounds["min"], tm._np_bounds["max"], (B, 7)).astype(np.float32)
    jdata = _batch(js, jm, q)
    jkeys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jconsts, jsalt, jbest = _np(jax.jit(js.engine._mega_prep)(jkeys, jdata))
    tstate, tconsts, tsalt, tbest = tree_to_numpy(ts.engine._mega_prep(
        tree_from_numpy(_np(jkeys), "cpu"), tree_from_numpy(_np(jdata), "cpu")))
    M = B * 2 * 2
    assert tstate[0].shape[-1] == M            # the port does not pad lanes
    for name, a, b in zip(("genes", "grads", "sfit", "sol"), tstate, jstate):
        np.testing.assert_array_equal(a, b[:, :M], err_msg=name)
    # seed fitness and tips: two FK implementations, float32
    np.testing.assert_allclose(tstate[4], jstate[4][:, :M], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tstate[5], jstate[5][:, :M], atol=1e-5)
    assert len(tconsts) == len(jconsts)
    for i, (a, b) in enumerate(zip(tconsts, jconsts)):
        np.testing.assert_array_equal(a, b[:, :M], err_msg=f"const {i}")
    np.testing.assert_array_equal(tsalt.view(np.uint32), jsalt[:, :M])
    np.testing.assert_array_equal(tbest[0], jbest[0])
    np.testing.assert_array_equal(tbest[2], jbest[2])
    np.testing.assert_allclose(tbest[1], jbest[1], rtol=1e-5, atol=1e-7)


def test_goal_rows_match_jax(rng):
    jm = JRobotModel.from_urdf_file(asset_path("pr2_dual.urdf"))
    tm = RobotModel.from_urdf_file(asset_path("pr2_dual.urdf"), device="cpu")
    L = "l_gripper_tool_frame"

    def goals(g):
        return [g.PoseGoal(link=TIP, weight=2.0, rotation_scale=0.3),
                g.PositionGoal(link=L, weight=0.5),
                g.OrientationGoal(link=L, weight=1.5)]

    js = JIKSolver(jm, goals(JG), JSolverConfig(fused="auto"))
    ts = IKSolver(tm, goals(G), SolverConfig())
    d0 = js.make_data(jnp.asarray(jm.neutral_q()))
    jdata = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=(B,) + x.shape).astype(np.float32)), d0)
    jrows = _np(js.engine._goal_rows(jdata, B))
    trows = tree_to_numpy(ts.engine._goal_rows(tree_from_numpy(_np(jdata), "cpu"), B))
    assert len(trows) == len(jrows) == 5          # gpos, gquat, gaux, wpos, wrot
    for a, b in zip(trows, jrows):
        np.testing.assert_array_equal(a, b)


def test_eval_lanes_and_merge_match_jax(arms, solvers, rng):
    jm, tm = arms
    js, ts = solvers
    qstar = rng.uniform(tm._np_bounds["min"], tm._np_bounds["max"], (B, 7)).astype(np.float32)
    jdata = _batch(js, jm, qstar)
    L, M = 4, B * 4
    # lane incumbents around each target: some within tolerance, some not,
    # and every lane of some scenarios outside it
    far = np.repeat(rng.uniform(size=B) < 0.4, L)[:, None]
    scale = np.where(far, 1e-2, rng.choice([1e-6, 1e-2], size=(M, 1)))
    sol = (np.repeat(qstar, L, 0) + rng.normal(size=(M, 7)) * scale).astype(np.float32)
    tips = j_make_fk(jm, [TIP])(jnp.asarray(sol))
    sol_tips = np.concatenate([np.asarray(tips.pos), np.asarray(tips.quat)], -1)[:, 0]
    sol_fit = rng.uniform(0, 1e-3, size=(1, M)).astype(np.float32)
    args = (sol.T.copy(), sol_fit, sol_tips.T.copy())
    jres = _np(jax.jit(js.engine._eval_lanes)(*[jnp.asarray(a) for a in args], jdata))
    tres = tree_to_numpy(ts.engine._eval_lanes(*tree_from_numpy(args, "cpu"),
                                               tree_from_numpy(_np(jdata), "cpu")))
    assert 0 < jres[2].sum() < B
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a, b)
    cand = (rng.normal(size=(B, 7)).astype(np.float32),
            rng.uniform(size=B).astype(np.float32), rng.uniform(size=B) < 0.5,
            rng.uniform(size=B).astype(np.float32))
    jm_ = _np(js.engine._merge(tuple(jnp.asarray(x) for x in jres),
                               tuple(jnp.asarray(x) for x in cand)))
    tm_ = tree_to_numpy(ts.engine._merge(tree_from_numpy(tuple(jres), "cpu"),
                                         tree_from_numpy(cand, "cpu")))
    for a, b in zip(tm_, jm_):
        np.testing.assert_array_equal(a, b)


def test_adaptive_take_rule():
    """api.py:102-116: a retry is adopted when it succeeds where the
    incumbent failed, or ties on success with lower fitness — and brings
    its own success flag."""
    res_ok = torch.tensor([False, False, True, True, False, True])
    sub_ok = torch.tensor([True, False, False, True, False, True])
    res_fit = torch.tensor([0.5, 0.5, 0.1, 0.1, 0.2, 0.1])
    sub_fit = torch.tensor([0.9, 0.4, 0.01, 0.05, 0.3, 0.2])
    want = [True, True, False, True, False, False]

    def result(ok, fit, tag):
        return IKResult(q=torch.full((6, 3), tag), success=ok, fitness=fit,
                        qa=torch.full((6, 2), tag))

    res = result(res_ok, res_fit, 0.0)
    idx = torch.tensor([5, 4, 3, 2, 1, 0])
    sub = result(sub_ok[idx], sub_fit[idx], 1.0)
    out = AdaptiveBatchSolver._take(res, idx, sub)
    assert (out.q[:, 0] == 1.0).tolist() == want
    assert out.success.tolist() == [bool(s if w else r) for s, r, w in
                                    zip(sub_ok.tolist(), res_ok.tolist(), want)]
    assert out.fitness.tolist() == [float(s if w else r) for s, r, w in
                                    zip(sub_fit.tolist(), res_fit.tolist(), want)]


def test_adaptive_solve_end_to_end(arms, rng):
    jm, tm = arms
    b = tm._np_bounds
    q = rng.uniform(b["min"], b["max"], (4, 7)).astype(np.float32)
    cfg = SolverConfig(mode="bio2_memetic", dtwist=1e-3)
    s = AdaptiveBatchSolver(tm, [G.PoseGoal(link=TIP)], cfg,
                            phases=((1, 2), (2, 2)), fractions=(0.5,))
    tg = make_fk(tm, [TIP])(torch.from_numpy(q))
    data = tree_map(lambda x: x.expand((4,) + x.shape).clone(),
                    s.make_data(torch.as_tensor(tm.neutral_q())))
    data["primary"][0]["position"] = tg.pos
    data["primary"][0]["orientation"] = tg.quat
    keys = torch.tensor([[0, 11], [0, 12], [0, 13], [0, 14]])
    res = s.solve_batch(keys, data)

    seed_fit = s.solvers[0].ctx.fitness_exact(data["seed_active"], data)
    assert bool((res.fitness <= seed_fit).all())

    # the JAX package's own fitness and acceptance test on the returned q
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)], JSolverConfig(mode="bio2_memetic",
                                                               dtwist=1e-3))
    jdata = jax.tree.map(jnp.asarray, tree_to_numpy(data))
    jq = jnp.asarray(res.q.numpy())
    jtips = j_make_fk(jm, [TIP])(jq)
    jok = np.asarray(js.problem.check_solution(JFrame(jtips.pos, jtips.quat),
                                               jq, jdata))
    jfit = np.asarray(js.problem.fitness(
        jnp.concatenate([jtips.pos, jtips.quat], -1), jq, jdata))
    np.testing.assert_array_equal(res.success.numpy(), jok)
    # returned fitness is the kernel's exact FK at the un-rewrapped genes
    np.testing.assert_allclose(res.fitness.numpy(), jfit, rtol=1e-5, atol=1e-9)

    again = s.solve_batch(keys, data)
    for a, b_ in zip(res, again):
        assert torch.equal(a, b_)
    keys2 = keys.clone()
    keys2[2, 1] = 99
    other = s.solve_batch(keys2, data)
    changed = (other.q != res.q).any(-1)
    assert changed.tolist() == [False, False, True, False]
