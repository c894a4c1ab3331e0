"""The high-DOF megastep instances of the port on the CPU: snake-32
((V, K, T) = (32, 1, 1)) and the 30-DOF humanoid ((30, 3, 3)), the JAX
suite's ``snake32_position`` and ``humanoid_whole_body`` rows.

The plain megastep body runs against the JAX package's on identical
inputs and noise tensors (``kernels/checks.megastep_inputs``), the JAX
body eagerly; the dependency columns of the wide layout against the JAX
chain's ``dts[v][t] is None`` pattern; the group-size rule with a fake
occupancy; one humanoid solve through the port's AdaptiveBatchSolver.
The CUDA instances (``csrc/megastep_high.cu``) are held to the plain
version on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.kernels.bio2_fullstep import array_draw_gen as j_array_draw_gen
from bio_ik_tpu.kernels.bio2_megastep import make_megastep_body as j_make_megastep_body
from bio_ik_tpu.kernels.bio2_step import SpeciesParams as JSpeciesParams
from bio_ik_tpu.kernels.fk_rows import FkRows as JFkRows

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import AdaptiveBatchSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import (
    MEGASTEP_SOURCES, Megastep, array_draw, choose_group, dependency_columns,
    make_megastep_body)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import HIGH_DOF, lane_agreement, megastep_inputs
from bio_ik_tpu_torch.kernels.fk_rows import FkRows

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

SP = dict(C=4, gens=1, mem_iters=2, memetic="q")


def _robot(name):
    urdf, tips, kinds, terms = HIGH_DOF[name]
    return RobotModel.from_urdf_file(asset_path(urdf), device="cpu"), list(tips), \
        list(kinds), terms


@pytest.mark.parametrize("name,with_terms,limit", [("snake", False, 0.8),
                                                   ("humanoid", True, 0.9)])
def test_high_dof_megastep_body_matches_jax(name, with_terms, limit):
    """One launch of the body, one step at N = 128, C = 4, one generation,
    two memetic iterations: snake-32 with its PositionGoal, the humanoid
    with three PoseGoals and the two regularizers' secondary terms.  The
    two versions round differently (torch's and XLA's sin, cos and sums),
    so the species fitness and the incumbent's must agree on every lane
    (atol 1e-6; measured ≤ 4.3e-9), and the whole state (every row within
    rtol 1e-5, atol 1e-6) on ``limit`` of the lanes: measured 1.0 on the
    humanoid, 0.867 on the snake, whose memetic line search over 32
    variables divides differences of near-equal fitness values and moves
    the genes of the lanes that part by ~1e-5 (without it: 1.0)."""
    model, tips, kinds, terms = _robot(name)
    terms = terms if with_terms else ()
    V, K = model.nvars, len(kinds)
    jm = JRobotModel.from_urdf_file(asset_path(HIGH_DOF[name][0]))
    sp = SpeciesParams(V=V, K=K, **SP)
    state, consts, noise = megastep_inputs(model, tips, sp, 1, 128, inst_kind=kinds,
                                           sec_terms=terms)
    inst = list(range(K))
    body, F = make_megastep_body(model, tips, list(range(V)), inst, sp, 1,
                                 sec_terms=terms, inst_kind=kinds)
    jbody, jF = j_make_megastep_body(jm, tips, list(range(V)), inst,
                                     JSpeciesParams(V=V, K=K, **SP), 1,
                                     use_pltpu_roll=False, sec_terms=terms,
                                     inst_kind=kinds, unroll=True)
    assert F == jF == 0
    keep = torch.from_numpy(noise[4]) if terms else None
    t_out = body(tree_from_numpy(state, "cpu"), tree_from_numpy(consts, "cpu"),
                 array_draw(*tree_from_numpy(noise[:4], "cpu"), sp.gens, keep=keep))
    jn = [jnp.asarray(x) for x in noise]

    def draw(i):
        return (j_array_draw_gen(jn[0], jn[1], jn[4] if terms else None),
                jn[2][i], jn[3][i])

    j_out = [np.asarray(x) for x in jbody(tuple(jnp.asarray(x) for x in state),
                                          tuple(jnp.asarray(x) for x in consts), draw)]
    assert lane_agreement(t_out[2::2], j_out[2::2], rtol=0.0).all()   # sfit, sol_fit
    assert lane_agreement(t_out, j_out).float().mean() >= limit


@pytest.mark.parametrize("name,ncol", [("snake", 32), ("humanoid", 22)])
def test_dependency_columns_match_jax(name, ncol):
    """The wide layout's columns: one per (v, t) on which tip t depends,
    exactly where the JAX chain's ``dts[v][t]`` is not None — all 32 of the
    snake's single chain, 22 of the humanoid's 90 (each hand on its arm
    and the torso, the head on the torso and the neck)."""
    model, tips, kinds, _ = _robot(name)
    V, T = model.nvars, len(tips)
    link_i = FkRows(model, tips, list(range(V))).chain_arrays()[0]
    cols, n = dependency_columns(link_i, V, T, list(range(len(kinds))))
    assert n == ncol
    jfr = JFkRows(JRobotModel.from_urdf_file(asset_path(HIGH_DOF[name][0])), tips,
                  list(range(V)))
    zero = [np.zeros(1, np.float32)]
    dts = jfr.deltas(jfr.frames(zero * V, zero * len(jfr.fixed_vars)))
    tcol = cols[:V * T].reshape(V, T)
    assert np.array_equal(tcol >= 0, [[d is not None for d in row] for row in dts])
    assert sorted(tcol[tcol >= 0].tolist()) == list(range(ncol))


def test_choose_group_leaves_out_what_does_not_fit():
    """A group size with no resident block is never chosen, whatever its
    estimate; with none that fits the rule raises."""
    # on 256 lanes every G takes one round: the largest G has the least
    # work per thread, and wins unless it does not fit
    assert choose_group(256, {1: 132, 2: 264, 4: 264}) == 4
    assert choose_group(256, {1: 132, 2: 264, 4: 0}) == 2
    assert choose_group(256, {1: 132, 2: 0, 4: 0}) == 1
    # the snake's secondary-goal instance: G = 1 does not fit, G = 2 one
    # block per SM, G = 4 two
    assert choose_group(524288, {1: 0, 2: 132, 4: 264}) == 4
    with pytest.raises(ValueError, match="no group size fits"):
        choose_group(4096, {1: 0, 2: 0, 4: 0})


def test_high_dof_wrappers_take_the_high_source():
    """Both instances live in csrc/megastep_high.cu (every goal kind, the
    linearization in shared memory), at the group size 2 alone."""
    assert MEGASTEP_SOURCES["megastep_high"] == ((32, 1, 1), (30, 3, 3))
    for name, ncol in (("snake", 32), ("humanoid", 22)):
        model, tips, kinds, terms = _robot(name)
        V, K = model.nvars, len(kinds)
        mega = Megastep(model, tips, list(range(V)), list(range(K)),
                        SpeciesParams(V=V, K=K), 1, sec_terms=terms, inst_kind=kinds)
        assert mega.source == "megastep_high" and mega.ncol == ncol
        assert mega.groups == (2,)


def test_humanoid_whole_body_solve_cpu():
    """The JAX suite's ``humanoid_whole_body`` problem (PoseGoals on both
    hands and the head at 1 cm, dtwist = ∞) through the port's
    AdaptiveBatchSolver on the CPU at B = 8, a 6 + 4-step ladder (the
    suite's runs 32 + 64 + 128 + 128 steps): success flags that the
    acceptance test re-derives from the returned q, and a worst-tip
    position error below the seed's."""
    model, tips, _, _ = _robot("humanoid")
    B = 8
    b = model._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"], size=(B, 30)).astype(np.float32)
    fk = make_fk(model, tips)
    tg = fk(torch.from_numpy(qg))
    s = AdaptiveBatchSolver(model, [G.PoseGoal(link=t) for t in tips],
                            SolverConfig(mode="bio2_memetic", dpos=1e-2,
                                         dtwist=float("inf")),
                            phases=((1, 6), (2, 4)), fractions=(0.5,))
    assert s.solvers[0].engine.mega.source == "megastep_high"
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                    s.make_data(torch.as_tensor(model.neutral_q())))
    data["primary"][0]["position"] = tg.pos
    data["primary"][0]["orientation"] = tg.quat
    keys = torch.stack([torch.zeros(B, dtype=torch.int64), torch.arange(B)], -1)
    res = s.solve_batch(keys, data)
    p = s.problem
    assert torch.equal(p.check_solution(fk(res.q), res.qa, data), res.success)

    def worst(q):
        return (fk(q).pos - tg.pos).norm(dim=-1).amax(-1)

    seed = torch.as_tensor(model.neutral_q(), dtype=torch.float32).expand(B, -1)
    assert float(worst(res.q).median()) < 0.5 * float(worst(seed).median())
