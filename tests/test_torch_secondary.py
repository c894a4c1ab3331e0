"""The port's joint-space secondary goals against the JAX package (CPU).

The five joint-space kinds (avoid_joint_limits, center_joints,
regularization, minimal_displacement, joint_variable), their packed kernel
rows (``engine._secondary_rows``), the row-level evaluator
(``make_sec_eval``), the ``sec_terms`` branches of the plain fullstep,
megastep and species versions, and the winner ranking with secondaries are
held to the JAX package on identical inputs made with numpy.

The JAX bodies run eagerly (op by op, as ``tests/test_torch_megastep.py``
does): jitted, XLA fuses and contracts the arithmetic, and the comparison
then measures XLA's rounding rather than the port (and compiles for ~50 s).
Eagerly the species step agrees bit for bit on every lane; the megastep
and fullstep bodies agree per lane within rtol 1e-5 on ≥ 90 % of lanes
(their sin/cos round differently, and a last-bit difference can flip a
selection; measured 97.7 % with the regularizers' terms, 98.4 % with all
four).  Evaluators: rtol 1e-5; the packed rows: exact.
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
from bio_ik_tpu.kernels.bio2_megastep import make_megastep_body as j_make_megastep_body
from bio_ik_tpu.kernels.bio2_step import (
    SpeciesParams as JSpeciesParams,
    make_sec_eval as j_make_sec_eval,
    make_species_inner as j_make_species_inner,
)
from bio_ik_tpu.math import Frame as JFrame
from bio_ik_tpu.problem import Problem as JProblem

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map, tree_to_numpy
from bio_ik_tpu_torch.kernels.bio2_fullstep import array_draw_gen, make_fullstep_inner
from bio_ik_tpu_torch.kernels.bio2_megastep import (
    Megastep,
    array_draw,
    make_megastep_body,
    philox_draw,
)
from bio_ik_tpu_torch.kernels.bio2_fullstep import (
    gauss_from_u01,
    philox_words,
    rate_from_bits,
    rates_from_words,
    u01_from_bits,
)
from bio_ik_tpu_torch.kernels.bio2_step import (
    SEC_TERMS,
    SpeciesKernel,
    SpeciesParams,
    make_sec_eval,
    make_species_inner,
)
from bio_ik_tpu_torch.kernels.checks import (
    lane_agreement,
    megastep_inputs,
    sec_rows,
    species_inputs,
)
from bio_ik_tpu_torch.math.frame import Frame
from bio_ik_tpu_torch.problem import Problem

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
V = 7
N = 256
SP = dict(V=V, K=1, C=4, gens=2, mem_iters=2, memetic="q")
REG = ("beta", "gamma")                 # MinimalDisplacement + AvoidJointLimits
TERM_SETS = [REG, SEC_TERMS]
KINDS = ("avoid_joint_limits", "center_joints", "regularization",
         "minimal_displacement", "joint_variable")
REG_CFG = dict(mode="bio2_memetic", dtwist=1e-3)
FIXED = ["r_wrist_roll_joint"]


@pytest.fixture(scope="module")
def arms():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


@pytest.fixture(scope="module")
def all_kinds(arms):
    """The JAX and the port's fused solvers of :func:`_all_kinds` with the
    wrist roll joint fixed (V = 6), two islands, ``dtwist = 1e-3``."""
    jm, tm = arms
    cfg = dict(REG_CFG, islands=2)
    js = JIKSolver(jm, _all_kinds(JG), JSolverConfig(fused="auto", **cfg),
                   fixed_joints=FIXED)
    ts = IKSolver(tm, _all_kinds(G), SolverConfig(**cfg), fixed_joints=FIXED)
    return js, ts


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _secondary(g, kind, weight=0.3, variable="r_elbow_flex_joint"):
    """One secondary goal of ``kind`` from goal module ``g``."""
    if kind == "avoid_joint_limits":
        return g.AvoidJointLimitsGoal(weight=weight)
    if kind == "center_joints":
        return g.CenterJointsGoal(weight=weight)
    if kind == "regularization":
        return g.RegularizationGoal(weight=weight, secondary=True)
    if kind == "minimal_displacement":
        return g.MinimalDisplacementGoal(weight=weight)
    return g.JointVariableGoal(variable_name=variable, variable_position=0.3,
                               weight=weight, secondary=True)


def _all_kinds(g):
    """Pose + all five kinds, one joint_variable on the variable of the
    fixed joint (inactive: the JAX package reads it from the seed and the
    kernel rows drop it)."""
    return ([g.PoseGoal(link=TIP)]
            + [_secondary(g, k, 0.1 + 0.1 * i) for i, k in enumerate(KINDS)]
            + [_secondary(g, "joint_variable", 0.7, "r_wrist_roll_joint")])


def _data(jp, tp, jm, rng, B):
    """The same per-scenario data on both sides: random seeds in the
    bounds, per-scenario weights² and joint_variable targets."""
    d0 = jp.make_data(jnp.asarray(jm.neutral_q()))
    jd = _np(jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0))
    b = jm._np_bounds
    seed = rng.uniform(b["min"], b["max"], size=(B, len(b["min"]))).astype(np.float32)
    jd["seed_full"] = seed
    jd["seed_active"] = seed[:, jp.active_vars]
    for grp in jd["secondary"]:
        grp["weight_sq"] = rng.uniform(0.01, 0.5, size=grp["weight_sq"].shape
                                       ).astype(np.float32)
        if "target" in grp:
            grp["target"] = rng.uniform(-1, 1, size=grp["target"].shape
                                        ).astype(np.float32)
    return jd, tree_from_numpy(jd, "cpu")


# ---- problem: builders, evaluators, acceptance --------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_secondary_evaluator_matches_jax(arms, kind, rng):
    jm, tm = arms
    jp = JProblem(jm, [JG.PoseGoal(link=TIP), _secondary(JG, kind)])
    tp = Problem(tm, [G.PoseGoal(link=TIP), _secondary(G, kind)])
    assert [g.kind for g in tp.secondary] == [g.kind for g in jp.secondary] == [kind]
    assert tp.secondary[0].goal_type == jp.secondary[0].goal_type == "unknown"
    B = 64
    jd, td = _data(jp, tp, jm, rng, B)
    b = tm._np_bounds
    qa = rng.uniform(b["min"] - 0.3, b["max"] + 0.3, size=(B, V)).astype(np.float32)
    j = np.asarray(jax.jit(jp.fitness_secondary)(jnp.asarray(qa), jd))
    t = tp.fitness_secondary(torch.from_numpy(qa), td).numpy()
    assert (j > 0).mean() > 0.5
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_all_kinds_fitness_and_inactive_variable_match_jax(arms, all_kinds, rng):
    jm, tm = arms
    jp, tp = (s.problem for s in all_kinds)
    assert tp.active_vars == jp.active_vars == list(range(6))
    assert [g.kind for g in tp.secondary] == [g.kind for g in jp.secondary]
    jv = [g for g in tp.secondary if g.kind == "joint_variable"][0]
    assert jv.static["slots"].tolist() == [3, -1]
    B = 64
    jd, td = _data(jp, tp, jm, rng, B)
    # the data tree, secondary entries included, survives interop
    for a, b_ in zip(jax.tree.leaves(tree_to_numpy(td)), jax.tree.leaves(jd)):
        np.testing.assert_array_equal(a, b_)
    b = tm._np_bounds
    qa = rng.uniform(b["min"][:6], b["max"][:6], size=(B, 6)).astype(np.float32)
    j = np.asarray(jax.jit(jp.fitness_secondary)(jnp.asarray(qa), jd))
    t = tp.fitness_secondary(torch.from_numpy(qa), td).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5)
    tips = make_fk(tm, [TIP])(torch.as_tensor(tm.neutral_q(), dtype=torch.float32)
                                + torch.zeros(B, 7))
    packed = np.concatenate([tips.pos.numpy(), tips.quat.numpy()], -1)
    jc = np.asarray(jax.jit(jp.fitness_combined)(jnp.asarray(packed),
                                                 jnp.asarray(qa), jd))
    tc = tp.fitness_combined(torch.from_numpy(packed), torch.from_numpy(qa), td)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5)


def test_joint_variable_primary_acceptance_matches_jax(arms, rng):
    """A joint_variable primary goal is accepted by Problem (for the
    acceptance test: ``w²·e < min(dpos, dtwist)²``) but not by the fused
    engine, as in the JAX package."""
    jm, tm = arms
    cfg = dict(dtwist=1e-3)

    def goals(g):
        return [g.JointVariableGoal(variable_name="r_elbow_flex_joint",
                                    variable_position=-1.0, weight=2.0)]

    jp = JProblem(jm, goals(JG), config=JSolverConfig(**cfg))
    tp = Problem(tm, goals(G), config=SolverConfig(**cfg))
    B = 256
    qa = np.tile(tm.neutral_q()[None], (B, 1)).astype(np.float32)
    qa[:, 3] = -1.0 + rng.uniform(-1e-3, 1e-3, size=B)
    jd = _np(jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                          jp.make_data(jnp.asarray(jm.neutral_q()))))
    td = tree_from_numpy(jd, "cpu")
    empty = np.zeros((B, 0, 3), np.float32), np.zeros((B, 0, 4), np.float32)
    jok = np.asarray(jp.check_solution(JFrame(*map(jnp.asarray, empty)),
                                       jnp.asarray(qa), jd))
    tok = tp.check_solution(Frame(*map(torch.from_numpy, empty)),
                            torch.from_numpy(qa), td).numpy()
    assert 0.1 < jok.mean() < 0.9
    np.testing.assert_array_equal(tok, jok)
    s = IKSolver(tm, goals(G), SolverConfig(**cfg))
    assert s.engine is None and "not in the fused fitness" in s.unsupported


@pytest.mark.parametrize("goal,item", [
    (G.BalanceGoal(), 5), (G.LinkFunctionGoal(link=TIP), 5),
    (G.TouchGoal(link=TIP), 5), (G.JointFunctionGoal(), 5)])
def test_unported_kinds_name_their_roadmap_item(arms, goal, item):
    """The four kinds of item 5d build beside a PoseGoal, and an IKSolver of
    them takes the island path: the fused kernels do not evaluate them."""
    p = Problem(arms[1], [G.PoseGoal(link=TIP), goal])
    assert [g.kind for g in p.primary][1] == {
        G.BalanceGoal: "balance", G.LinkFunctionGoal: "link_function",
        G.TouchGoal: "touch", G.JointFunctionGoal: "joint_function"}[type(goal)]
    s = IKSolver(arms[1], [G.PoseGoal(link=TIP), goal])
    assert s.engine is None and "not in the fused fitness" in s.unsupported


def test_secondary_goals_must_be_joint_space(arms):
    with pytest.raises(ValueError, match="joint-space"):
        Problem(arms[1], [G.PoseGoal(link=TIP),
                          G.PositionGoal(link=TIP, secondary=True)])


# ---- engine: packed rows, winner ranking, entry points ------------------


def test_secondary_rows_match_jax(arms, all_kinds, rng):
    jm, tm = arms
    js, ts = all_kinds
    assert ts.engine.sec_terms == js.engine.sec_terms == tuple(sorted(SEC_TERMS))
    B = 16
    jd, td = _data(js.problem, ts.problem, jm, rng, B)
    j = np.asarray(js.engine._secondary_rows(jax.tree.map(jnp.asarray, jd), B))
    t = ts.engine._secondary_rows(td, B).numpy()
    assert t.shape == (B, 8 * 6)
    np.testing.assert_array_equal(t, j)


def test_winner_ranks_successes_by_combined_fitness_as_jax(arms, all_kinds, rng):
    """_eval_lanes on injected lane incumbents of the all-kinds problem: the
    successes of a scenario are ranked by primary + secondary fitness (the
    secondary decides among equal primaries), failures by primary."""
    jm, tm = arms
    js, ts = all_kinds
    B, L, Va = 8, 4, 6
    M = B * L
    jd, td = _data(js.problem, ts.problem, jm, rng, B)
    b = tm._np_bounds
    qstar = rng.uniform(b["min"], b["max"], (B, 7)).astype(np.float32)
    qstar[:, Va:] = jd["seed_full"][:, Va:]          # the fixed joint's seed
    tg = make_fk(tm, [TIP])(torch.from_numpy(qstar))
    jd["primary"][0]["position"] = tg.pos.numpy()
    jd["primary"][0]["orientation"] = tg.quat.numpy()
    # near lanes 1e-4 rad off (inside the 1 mm box, their secondary
    # fitness apart by far more than rounding), far lanes 1e-2
    far = np.repeat(rng.uniform(size=B) < 0.3, L)[:, None]
    scale = np.where(far, 1e-2, rng.choice([1e-4, 1e-2], size=(M, 1)))
    q = np.repeat(qstar, L, 0)
    q[:, :Va] += rng.normal(size=(M, Va)) * scale
    q = q.astype(np.float32)
    tips = make_fk(tm, [TIP])(torch.from_numpy(q))
    sol_tips = torch.cat([tips.pos, tips.quat], -1)[:, 0].numpy()
    # equal primary fitness within each scenario: the secondary decides
    sol_fit = np.repeat(rng.uniform(0, 1e-3, size=(1, B)), L, 1).astype(np.float32)
    args = (q[:, :Va].T.copy(), sol_fit, sol_tips.T.copy())
    jres = _np(jax.jit(js.engine._eval_lanes)(*[jnp.asarray(a) for a in args],
                                              jax.tree.map(jnp.asarray, jd)))
    tres = tree_to_numpy(ts.engine._eval_lanes(*tree_from_numpy(args, "cpu"),
                                               tree_from_numpy(jd, "cpu")))
    assert 0 < jres[2].sum() < B
    for a, b_ in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(a, b_)
    np.testing.assert_allclose(tres[3], jres[3], rtol=1e-5)


def test_for_tips_builds_the_regularized_problem(arms):
    """IKSolver.for_tips with the plugin's regularizer weights (the
    reference's load()) builds the problem of the regularized path."""
    tm = arms[1]
    ft = IKSolver.for_tips(tm, [TIP], SolverConfig(
        minimal_displacement_weight=0.05, avoid_joint_limits_weight=0.05,
        **REG_CFG))
    rg = IKSolver(tm, [G.PoseGoal(link=TIP),
                       G.MinimalDisplacementGoal(weight=0.05),
                       G.AvoidJointLimitsGoal(weight=0.05)], SolverConfig(**REG_CFG))
    assert ft.engine.sec_terms == rg.engine.sec_terms == REG
    assert sorted((g.kind, float(g.weight_sq[0])) for g in ft.problem.secondary) \
        == sorted((g.kind, float(g.weight_sq[0])) for g in rg.problem.secondary)

    def rows(s):
        d = tree_map(lambda x: x[None], s.make_data(tm.neutral_q()))
        return s.engine._secondary_rows(d, 1)

    assert torch.equal(rows(ft), rows(rg))


def test_regularized_solve_cpu(arms):
    """Path (a)'s goals and configuration end to end on the CPU at B = 8,
    16 steps and 2 islands, on targets within ~0.2 rad of the seed (at
    path (a)'s uniform targets 16 steps of 4 islands do not reach 1 mm even
    without the regularizers: 6 of 8; the JAX suite's own test of this
    configuration asserts only a 1 cm median, tests/test_kernel.py:564):
    every scenario succeeds, the flags are the acceptance test's, and the
    secondary fitness is below the pose-only solve's on the same targets
    (mean over the 8).  ``chip_smoke.py`` repeats the solve for
    determinism at B = 65 536."""
    tm = arms[1]
    B = 8
    goals = [G.PoseGoal(link=TIP), G.MinimalDisplacementGoal(weight=0.05),
             G.AvoidJointLimitsGoal(weight=0.05)]
    cfg = SolverConfig(max_steps=16, steps_per_check=16, islands=2, **REG_CFG)
    s = IKSolver(tm, goals, cfg)
    b = tm._np_bounds
    qn = tm.neutral_q()
    qg = np.clip(qn + np.random.default_rng(0).normal(size=(B, 7)) * 0.2,
                 b["min"], b["max"])
    tg = make_fk(tm, [TIP])(torch.as_tensor(qg, dtype=torch.float32))
    keys = torch.stack([torch.zeros(B, dtype=torch.int64), torch.arange(B)], -1)

    def solve(solver):
        data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                        solver.make_data(qn))
        data["primary"][0]["position"] = tg.pos.contiguous()
        data["primary"][0]["orientation"] = tg.quat.contiguous()
        return solver.solve_batch(keys, data), data

    Megastep.launches = 0
    res, data = solve(s)
    assert Megastep.launches == 0              # CPU: the plain version
    assert bool(res.success.all())
    p = s.problem
    ok = p.check_solution(make_fk(tm, [TIP])(res.q), res.qa, data)
    assert torch.equal(ok, res.success)
    res0, _ = solve(IKSolver(tm, goals[:1], cfg))
    assert bool(res0.success.all())
    assert float(p.fitness_secondary(res.qa, data).mean()) < float(
        p.fitness_secondary(res0.qa, data).mean())


def _generator_draws(eng, salt_row, B):
    """The species tier's earlier kind of randomness, for comparison:
    per-step ``torch.Generator`` words XORed with each scenario's salt,
    mapped to CLT4 noise, rates, wipe words and keeps as the JAX engine
    maps its words; a ``draws`` for ``_species_solve``."""
    sp, I = eng.sp, eng.islands
    V, C, M = sp.V, sp.C, salt_row.shape[-1]
    salt_bi = salt_row[0].reshape(B, I, 2)[..., 0]

    def draws(step):
        gen = torch.Generator().manual_seed(1000 + step)

        def words(*shape):
            return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                 generator=gen)

        noise = torch.stack([gauss_from_u01(
            [u01_from_bits(words(V, C, M) ^ salt_row) for _ in range(4)], "clt4")
            for _ in range(sp.gens)])
        rates = rate_from_bits(words(sp.gens, C, M) ^ salt_row)
        wipe_u = u01_from_bits(words(B, I) ^ salt_bi)
        wipe_g = u01_from_bits(words(B, I, V) ^ salt_bi[..., None])
        return noise, rates, wipe_u, wipe_g, u01_from_bits(words(sp.gens, 1, M) ^ salt_row)
    return draws


def test_species_tier_with_regularizers_cpu():
    """Path (b)'s goals on the species tier: keeps drawn with the step's
    other words, the secondary rows in the kernel, solved within the
    configuration's budget (16 steps), and at 8 steps as often as with the
    earlier kind of noise (generator words) on the same targets, each
    scenario's result the same in a batch of 4 as in a batch of 256.  At
    8 steps a single scenario is a matter of luck under either stream (the
    first target is solved for ~0.3 of keys), so quality is held on 4
    targets × 64 keys."""
    tm = RobotModel.from_urdf_file(asset_path("planar_arm.urdf"), device="cpu")
    goals = [G.PositionGoal(link="tool"), G.MinimalDisplacementGoal(weight=0.05),
             G.AvoidJointLimitsGoal(weight=0.05)]
    cfg = dict(mode="bio2_memetic", dpos=5e-3, dtwist=float("inf"), islands=2)
    b = tm._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"], size=(4, 5))

    def batch(s, R):
        B = 4 * R
        tg = make_fk(tm, ["tool"])(torch.as_tensor(np.repeat(qg, R, 0),
                                                   dtype=torch.float32))
        data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                        s.make_data(tm.neutral_q()))
        data["primary"][0]["position"] = tg.pos.contiguous()
        keys = torch.stack([torch.arange(B) % R, torch.arange(B)], -1)
        return keys, data

    s = IKSolver(tm, goals, SolverConfig(max_steps=16, **cfg))
    eng = s.engine
    assert not eng.fullstep and eng.sec_terms == REG and eng.kernel.sec_terms == REG
    B = 4
    keys, data = batch(s, 1)
    salt_row = torch.zeros((1, B * 4), dtype=torch.int32)
    kw, _, _ = eng._species_stream(0, 0, salt_row)
    d = eng.kernel.philox_tensors(kw["seed"], kw["step"], salt_row)
    assert len(d) == 3 and tuple(d[2].shape) == (eng.sp.gens, 1, B * 4)
    assert 0.0 <= float(d[2].min()) and float(d[2].max()) < 1.0
    assert bool(s.solve_batch(keys, data).success.all())
    # at 8 steps, 64 keys per target: the engine's stream against
    # generator words injected in tensor mode
    s8 = IKSolver(tm, goals, SolverConfig(max_steps=8, **cfg))
    keys, data = batch(s8, 64)
    own = s8.solve_batch(keys, data)
    gen = s8.engine._species_solve(keys, data, _generator_draws(
        s8.engine, s8.engine._lane_setup(keys, data)["salt_row"], 256))
    rate, gen_rate = float(own.success.float().mean()), float(gen.success.float().mean())
    assert rate >= gen_rate - 0.1, (rate, gen_rate)
    first = s8.solve_batch(keys[:4], tree_map(lambda x: x[:4].contiguous(), data))
    for a, b_ in zip(first, own):
        assert torch.equal(a, b_[:4])


# ---- kernels' plain versions --------------------------------------------


@pytest.mark.parametrize("terms", TERM_SETS, ids="_".join)
def test_sec_eval_matches_jax(arms, terms, rng):
    tm = arms[1]
    sec = sec_rows(tm, terms, N, rng, weight=0.3)
    b = tm._np_bounds
    xs = np.ascontiguousarray(rng.uniform(b["min"] - 0.2, b["max"] + 0.2,
                                          size=(4, N, V)).T.swapaxes(1, 2),
                              dtype=np.float32)               # (V, 4, N)
    t_of, t_grad = make_sec_eval(torch.from_numpy(sec), V, terms)
    j_of, j_grad = j_make_sec_eval(jnp.asarray(sec), V, terms)
    tx, jx = torch.from_numpy(xs), [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(t_of(tx).numpy(), np.asarray(j_of(jx)), rtol=1e-6)
    for v in range(V):
        np.testing.assert_allclose(t_grad(tx, v).numpy(), np.asarray(j_grad(jx, v)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("terms", TERM_SETS, ids="_".join)
def test_species_inner_sec_matches_jax(terms):
    tm = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    sp = dict(V=10, K=1, C=4, gens=2, mem_iters=2, memetic="q", quat_slices=(3,))
    args = species_inputs(tm, "tool", SpeciesParams(**sp), N, sec_terms=terms)
    out = make_species_inner(SpeciesParams(**sp), terms)(*tree_from_numpy(args, "cpu"))
    ref = j_make_species_inner(JSpeciesParams(**sp), terms)(
        *[jnp.asarray(a) for a in args])
    assert lane_agreement(out, [np.asarray(r) for r in ref]).float().mean() >= 0.9


@pytest.fixture(scope="module")
def sec_inputs(arms):
    return {terms: megastep_inputs(arms[1], TIP, SpeciesParams(**SP), 2, N,
                                   sec_terms=terms) for terms in TERM_SETS}


@pytest.mark.parametrize("terms", TERM_SETS, ids="_".join)
def test_megastep_body_sec_matches_jax(arms, sec_inputs, terms):
    jm, tm = arms
    state, consts, noise = sec_inputs[terms]
    body, _ = make_megastep_body(tm, [TIP], list(range(V)), [0],
                                 SpeciesParams(**SP), 2, sec_terms=terms)
    t_out = body(tree_from_numpy(state, "cpu"), tree_from_numpy(consts, "cpu"),
                 array_draw(*tree_from_numpy(noise[:4], "cpu"), SP["gens"],
                            keep=torch.from_numpy(noise[4])))
    jbody, _ = j_make_megastep_body(jm, [TIP], list(range(V)), [0],
                                    JSpeciesParams(**SP), 2, use_pltpu_roll=False,
                                    unroll=True, sec_terms=terms)
    jn = [jnp.asarray(x) for x in noise]

    def draw(i):
        g = slice(i * SP["gens"], (i + 1) * SP["gens"])
        return j_array_draw_gen(jn[0][g], jn[1][g], jn[4][g]), jn[2][i], jn[3][i]

    j_out = [np.asarray(x) for x in jbody(tuple(jnp.asarray(x) for x in state),
                                          tuple(jnp.asarray(x) for x in consts), draw)]
    assert lane_agreement(t_out, j_out).float().mean() >= 0.9


def test_fullstep_inner_sec_matches_jax(arms, sec_inputs):
    jm, tm = arms
    state, consts, noise = sec_inputs[REG]
    args = (state[0], state[1]) + tuple(consts[:8]) + (consts[10],)
    tinner, _ = make_fullstep_inner(tm, [TIP], list(range(V)), [0],
                                    SpeciesParams(**SP), sec_terms=REG)
    jinner, _ = j_make_fullstep_inner(jm, [TIP], list(range(V)), [0],
                                      JSpeciesParams(**SP), sec_terms=REG)
    g = slice(0, SP["gens"])
    t_out = tinner(*tree_from_numpy(args, "cpu"), array_draw_gen(
        *tree_from_numpy((noise[0][g], noise[1][g], noise[4][g]), "cpu")))
    j_out = jinner(*[jnp.asarray(a) for a in args], j_array_draw_gen(
        *[jnp.asarray(x[g]) for x in (noise[0], noise[1], noise[4])]))
    assert lane_agreement(t_out, [np.asarray(x) for x in j_out]).float().mean() >= 0.9


def test_philox_keep_word():
    """The keep uniform of generation g is the last word of the
    generation's rate call (Philox draw V·C, whose first two words hold the
    C = 16 rates): the same bits on every call, no Gaussian's word, and
    drawing it leaves the noise and rates unchanged."""
    C, n = 16, 256
    salt = torch.arange(n, dtype=torch.int32)[None] // 2
    draw_gen = philox_draw(11, salt, V, C, keep=True)(3)[0]
    noise, rates, keep = draw_gen(1)
    again = philox_draw(11, salt, V, C, keep=True)(3)[0](1)
    assert all(torch.equal(a, b) for a, b in zip((noise, rates, keep), again))
    plain = philox_draw(11, salt, V, C)(3)[0](1)
    assert len(plain) == 2
    assert torch.equal(plain[0], noise) and torch.equal(plain[1], rates)
    assert tuple(keep.shape) == (1, n) and 0.0 <= float(keep.min()) < 1.0
    lane = torch.arange(n, dtype=torch.int64)[None]
    s64 = salt.to(torch.int64)
    rw = philox_words(11, lane, 3, 1, torch.tensor([[V * C]]), s64)
    assert torch.equal(keep, u01_from_bits(rw[3]))
    assert torch.equal(rates, rates_from_words(rw, C))
    used = philox_words(11, lane, 3, 1, torch.arange(V * C)[:, None], s64)
    assert not any(bool((w == rw[3]).any()) for w in used)
    assert float(keep.std()) > 0.25


def test_wrappers_with_secondary_take_the_plain_version_on_cpu(arms, sec_inputs):
    tm = arms[1]
    sp = SpeciesParams(**SP)
    state, consts, noise = tree_from_numpy(sec_inputs[REG], "cpu")
    mega = Megastep(tm, [TIP], list(range(V)), [0], sp, 2, sec_terms=REG)
    Megastep.launches = SpeciesKernel.launches = 0
    out = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
               wipe_g=noise[3], keep=noise[4])
    ref = mega.body(state, consts, array_draw(*noise[:4], sp.gens, keep=noise[4]))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="keep"):
        mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
             wipe_g=noise[3])
    fm = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    ssp = SpeciesParams(V=10, K=1, C=4, gens=2, mem_iters=2, quat_slices=(3,))
    args = tree_from_numpy(species_inputs(fm, "tool", ssp, 64, sec_terms=REG), "cpu")
    kern = SpeciesKernel(ssp, REG)
    assert all(torch.equal(a, b) for a, b in zip(kern(*args), kern.inner(*args)))
    with pytest.raises(ValueError, match="keeps"):
        kern(*args[:13])
    assert Megastep.launches == SpeciesKernel.launches == 0


# ---- on the card ---------------------------------------------------------


@pytest.mark.cuda
def test_sec_megastep_cuda_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    sp = SpeciesParams(**SP)
    state, consts, noise = tree_from_numpy(
        megastep_inputs(tm, TIP, sp, 2, 4096, sec_terms=REG), "cuda")
    mega = Megastep(tm, [TIP], list(range(V)), [0], sp, 2, sec_terms=REG)
    out = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
               wipe_g=noise[3], keep=noise[4])
    ref = mega.body(state, consts, array_draw(*noise[:4], sp.gens, keep=noise[4]))
    torch.cuda.synchronize()
    assert lane_agreement(out, ref).float().mean() >= 0.85


@pytest.mark.cuda
def test_sec_species_cuda_kernel_is_bitwise_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    sp = SpeciesParams(V=10, K=1, quat_slices=(3,))
    args = tree_from_numpy(species_inputs(tm, "tool", sp, 4096, sec_terms=REG), "cuda")
    kern = SpeciesKernel(sp, REG)
    out, ref = kern(*args), kern.inner(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
