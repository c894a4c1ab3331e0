"""The eight goal kinds the fused step evaluates besides the pose family
(lookat, max_distance, min_distance, line, plane, side, direction, cone)
against the JAX package (CPU).

Each kind's ``Problem.fitness`` and ``check_solution`` on ``pr2_arm`` at
256 random configurations; the engine's goal rows (``_goal_rows``, with
the ``gaux`` rows and the row reuse per kind); and the plain fused step
``make_fullstep_inner`` with a PoseGoal and one instance of the kind, from
the same noise tensors (``kernels/checks.megastep_inputs``), against the
JAX package's plain-jnp body run eagerly.  The CUDA kernels are held to
the plain version on the card by ``chip_smoke.py``.
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
from bio_ik_tpu.kernels.bio2_fullstep import (
    array_draw_gen as j_array_draw_gen,
    make_fullstep_inner as j_make_fullstep_inner,
)
from bio_ik_tpu.kernels.bio2_step import SpeciesParams as JSpeciesParams
from bio_ik_tpu.math import Frame as JFrame
from bio_ik_tpu.problem import Problem as JProblem

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_to_numpy
from bio_ik_tpu_torch.kernels.bio2_fullstep import (LINK_KINDS, array_draw_gen,
                                                    make_fullstep_inner)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs
from bio_ik_tpu_torch.problem import Problem

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
# one instance of each kind, placed so that the errors of random
# configurations spread over decades
PARAMS = {
    "lookat": dict(axis=(1.0, 0.0, 0.0), target=(0.5, -0.3, 0.8)),
    "max_distance": dict(target=(0.6, -0.2, 0.7), distance=0.3),
    "min_distance": dict(target=(0.6, -0.2, 0.7), distance=0.9),
    "line": dict(position=(0.5, -0.2, 0.8), direction=(0.0, 0.0, 1.0)),
    "plane": dict(position=(0.5, 0.0, 0.8), normal=(0.3, 0.2, 1.0)),
    "side": dict(axis=(1.0, 0.0, 0.0), direction=(0.0, 0.0, 1.0)),
    "direction": dict(axis=(0.0, 0.0, 1.0), direction=(0.0, 1.0, 1.0)),
    "cone": dict(axis=(1.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0), angle=0.5,
                 position=(0.5, -0.2, 0.8), position_weight=0.3),
}
CLS = {"lookat": "LookAtGoal", "max_distance": "MaxDistanceGoal",
       "min_distance": "MinDistanceGoal", "line": "LineGoal", "plane": "PlaneGoal",
       "side": "SideGoal", "direction": "DirectionGoal", "cone": "ConeGoal"}
SP = dict(V=7, K=2, C=4, gens=2, mem_iters=2, memetic="q")


def _goal(lib, kind, weight=0.7):
    return getattr(lib, CLS[kind])(link=TIP, weight=weight, **PARAMS[kind])


@pytest.fixture(scope="module")
def arms():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


@pytest.mark.parametrize("kind", LINK_KINDS)
def test_fitness_and_check_solution_match_jax(kind, arms, rng):
    jm, tm = arms
    b = tm._np_bounds
    q = rng.uniform(b["min"], b["max"], size=(256, 7)).astype(np.float32)
    tips = make_fk(tm, [TIP])(torch.from_numpy(q))
    packed = np.concatenate([tips.pos.numpy(), tips.quat.numpy()], -1)

    def run(dpos):
        cfg = dict(dpos=dpos, drot=float("inf"), dtwist=float("inf"))
        jp = JProblem(jm, [_goal(JG, kind)], config=JSolverConfig(**cfg))
        tp = Problem(tm, [_goal(G, kind)], config=SolverConfig(**cfg))
        jd = jp.make_data(jnp.asarray(jm.neutral_q()))
        td = tp.make_data(torch.as_tensor(tm.neutral_q()))
        jt = JFrame(jnp.asarray(tips.pos.numpy()), jnp.asarray(tips.quat.numpy()))
        jok = np.asarray(jp.check_solution(jt, jnp.asarray(q), jd))
        tok = tp.check_solution(tips, torch.from_numpy(q), td).numpy()
        jfit = np.asarray(jp.fitness(jnp.asarray(packed), jnp.asarray(q), jd))
        tfit = tp.fitness(torch.from_numpy(packed), torch.from_numpy(q), td).numpy()
        return jok, tok, jfit, tfit

    _, _, jfit, _ = run(1.0)
    pos = jfit[jfit > 0]
    assert pos.size > 64 and np.ptp(np.log10(pos)) > 1.0   # errors spread over decades
    # the acceptance edge at the median non-zero weighted error (the relu
    # kinds meet some configurations exactly): flags split both ways
    tol = float(np.sqrt(np.median(pos)))
    jok, tok, jfit, tfit = run(tol)
    # float32 evaluators in another order (XLA against eager torch): ulps
    np.testing.assert_allclose(tfit, jfit, rtol=1e-5, atol=1e-9)
    # keep samples ≥ 1 % of the tolerance from its edge
    stable = (run(0.99 * tol)[0] == jok) & (run(1.01 * tol)[0] == jok)
    assert stable.sum() > 200 and 0.05 < jok[stable].mean() < 0.95
    np.testing.assert_array_equal(tok[stable], jok[stable])


def test_goal_rows_of_every_kind_match_jax(arms, rng):
    """``engine._goal_rows`` with a PoseGoal and one instance of each kind
    (K = 9): gpos, gquat, gaux, wpos, wrot bit for bit on random data."""
    jm, tm = arms
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)] + [_goal(JG, k) for k in LINK_KINDS],
                   JSolverConfig(fused="auto"))
    ts = IKSolver(tm, [G.PoseGoal(link=TIP)] + [_goal(G, k) for k in LINK_KINDS],
                  SolverConfig())
    assert js.engine.inst_kind == ts.engine.inst_kind
    assert ts.engine.has_aux and len(ts.engine.inst_kind) == 9
    B = 8
    d0 = js.make_data(jnp.asarray(jm.neutral_q()))
    jdata = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=(B,) + x.shape).astype(np.float32)), d0)
    jrows = jax.tree.map(np.asarray, js.engine._goal_rows(jdata, B))
    trows = tree_to_numpy(ts.engine._goal_rows(
        tree_from_numpy(jax.tree.map(np.asarray, jdata), "cpu"), B))
    assert len(trows) == len(jrows) == 5
    for a, b in zip(trows, jrows):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", LINK_KINDS)
def test_fullstep_inner_with_kind_matches_jax(kind, arms):
    """One fused step with a PoseGoal and an instance of ``kind`` on the
    same tip: the port's plain body against the JAX body on identical
    noise tensors (N = 256, parents 1e-3 rad from a configuration that
    meets the PoseGoal; the kind's rows miss it, so its term acts on every
    lane: checks.megastep_inputs).  Lane agreement as the pose family's own
    test (test_torch_megastep.py): ≥ 0.9 (measured 0.95–0.99); with the
    kind's term dropped (its weight zeroed) the port's body agrees with
    JAX's on under half the lanes (measured 0.0)."""
    jm, tm = arms
    kinds = ["pose", kind]
    state, consts, noise = megastep_inputs(tm, TIP, SpeciesParams(**SP), 1, 256,
                                           inst_kind=kinds, inst_tip=[0, 0])
    args = (state[0], state[1]) + tuple(consts[:-2])
    tinner, _ = make_fullstep_inner(tm, [TIP], list(range(7)), [0, 0],
                                    SpeciesParams(**SP), inst_kind=kinds)
    jinner, _ = j_make_fullstep_inner(jm, [TIP], list(range(7)), [0, 0],
                                      JSpeciesParams(**SP), inst_kind=kinds)

    def port(a):
        return tinner(*tree_from_numpy(a, "cpu"),
                      array_draw_gen(*tree_from_numpy(noise[:2], "cpu")))

    t_out = port(args)
    j_out = jinner(*[jnp.asarray(a) for a in args],
                   j_array_draw_gen(jnp.asarray(noise[0]), jnp.asarray(noise[1])))
    j_out = [np.asarray(x) for x in j_out]
    assert [tuple(t.shape) for t in t_out] == [x.shape for x in j_out]
    assert lane_agreement(t_out, j_out).float().mean() >= 0.9
    dropped = list(args)
    i = len(args) - 5                      # wpos: before wrot, span, clip_min, clip_max
    dropped[i] = dropped[i].copy()
    dropped[i][1] = 0.0
    assert lane_agreement(port(dropped), j_out).float().mean() < 0.5
