"""The port's unfused bio2 solver and its registry against the JAX package
(CPU).

``Bio2Solver._reproduce`` and ``step`` are fed the JAX package's own draws
— recreated here with the same ``jax.random`` calls (JAX
solvers/bio2.py:114-123, :146, :255-307) — and held to the JAX solver's
outputs on the same inputs: ``_reproduce`` within 1e-6, ``step`` within
1e-5.  The memetic gradient (torch.autograd against ``jax.grad``) within
1e-5 for every goal kind the island path meets, the four only it
evaluates (touch, balance, link_function, joint_function) among them.
``_memetic`` within 1e-5 in float64 on both sides: its quadratic step
divides a second difference
of three nearly equal fitness values, which in float32 carries the two
packages' last-bit differences in the approximate fitness (≤ 2e-6
relative, the einsum's order) up to 1e-4 in the genes on half the rows.
Inputs are made with numpy and carried across with ``interop``; the
linearization is the port's (the same numbers on both sides).
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
from bio_ik_tpu.solvers.base import solver_names as j_solver_names
from bio_ik_tpu.solvers.bio2 import Bio2State as JBio2State

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map
from bio_ik_tpu_torch.solvers.base import solver_names
from bio_ik_tpu_torch.solvers.bio2 import Bio2Draws, _lead

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
C = 16


def _np(tree):
    return jax.tree.map(np.array, tree)


def _goals(mod, case):
    """Goal lists by case, for either package's goals module."""
    if case == "pose":
        return [mod.PoseGoal(link=TIP)]
    if case == "regularized":
        return [mod.PoseGoal(link=TIP), mod.MinimalDisplacementGoal(weight=0.3),
                mod.AvoidJointLimitsGoal(weight=0.3)]
    return [mod.PositionGoal(link="tool")]


def _pair(case, mode="bio2_memetic", dtype="float32"):
    """The JAX and the port's island solvers of one problem (CPU)."""
    urdf = "free_arm.urdf" if case == "free" else "pr2_arm.urdf"
    jm = JRobotModel.from_urdf_file(asset_path(urdf))
    tm = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
    cfg = dict(mode=mode, dtwist=1e-3, fused="off", dtype=dtype)
    js = JIKSolver(jm, _goals(JG, case), JSolverConfig(**cfg))
    ts = IKSolver(tm, _goals(G, case), SolverConfig(**cfg))
    return jm, tm, js, ts


def _rows(jm, tm, js, rng, n, spread=0.05):
    """n rows of one problem: JAX data per row (targets at FK of q*) and
    parents about q*, in the problem's dtype."""
    b = tm._np_bounds
    qs = rng.uniform(b["min"] * 0.5, b["max"] * 0.5, (n, tm.nvars))
    qs = np.where(np.isfinite(qs), qs, 0.0).astype(js.problem.dtype)
    tips = js.problem.tip_links
    tg = make_fk(tm, tips)(torch.from_numpy(qs))
    tg = tg._replace(pos=tg.pos.numpy(), quat=tg.quat.numpy())
    d0 = js.make_data(jnp.asarray(jm.neutral_q()))
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
    for gi, grp in enumerate(js.problem.primary):
        if "position" in jd["primary"][gi]:
            jd["primary"][gi]["position"] = tg.pos[:, grp.tip_slots]
        if "orientation" in jd["primary"][gi]:
            jd["primary"][gi]["orientation"] = tg.quat[:, grp.tip_slots]
    dt = js.problem.dtype
    jd = jax.tree.map(lambda a: a.astype(dt) if a.dtype.kind == "f" else a, _np(jd))
    av = np.asarray(js.problem.active_vars)
    V = len(av)
    genes = (qs[:, None, av] + rng.normal(0, spread, (n, 2, V))).astype(dt)
    grads = rng.normal(0, 1e-3, (n, 2, V)).astype(dt)
    return jd, genes, grads


def _lin(ts, td, x0):
    """The port's linearization at ``x0 (n, V)`` as numpy."""
    ctx = ts.ctx
    t0, dl = ctx.linearize(ctx.qfull(td["seed_full"], torch.from_numpy(x0)))
    return t0.numpy(), dl.numpy()


# ---------------------------------------------------------------------------
# registry


def test_registry_names_are_jax_names():
    """The port registers exactly the JAX package's mode names: the bio2
    family, bio1, the 12 gd, 4 jac and 56 optlib names, neural, neural2 and
    test; no mode is left to port."""
    assert solver_names() == sorted(j_solver_names())
    assert len(solver_names()) == 80


@pytest.mark.parametrize("mode,item", [
    ("bio1", "5b"), ("gd", "5b"), ("gd_c_8", "5b"), ("jac_2", "5b"), ("test", "5b"),
    ("optlib_lbfgs", "5c"), ("optlib_nm_r_4", "5c"), ("neural2", "5c"),
    ("bio2_memetic_lbfgs", "5c")])
def test_pending_modes_name_their_item(mode, item):
    """The modes the port once listed as pending, by the ROADMAP.md port
    queue item that ported them (5b, 5c), each build on the island path and
    run one step of one query to a finite result."""
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    s = IKSolver(m, [G.PoseGoal(link=TIP)],
                 SolverConfig(mode=mode, max_steps=1, steps_per_check=1,
                              neural_train_steps=20))
    assert s.engine is None and "not a fused bio2 family" in s.unsupported
    res = s.solve(torch.as_tensor(m.neutral_q()), key=[0, 3])
    assert res.q.shape == (m.nvars,) and torch.isfinite(res.q).all()
    assert torch.isfinite(res.fitness)


def test_unknown_mode_raises():
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    with pytest.raises(ValueError, match="unknown solver mode"):
        IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(mode="nope"))


# ---------------------------------------------------------------------------
# one generation, the memetic phase, one step — against the JAX solver


def _j_reproduce_draws(key, V):
    """JAX _reproduce's draws (bio2.py:114-123, :146)."""
    k_rate, k_noise, k_keep = jax.random.split(key, 3)
    return (jax.random.randint(k_rate, (C,), 0, 16),
            jax.random.normal(k_noise, (C, V), jnp.float32),
            jax.random.randint(k_keep, (), 1, C))


@pytest.mark.parametrize("case", ["pose", "regularized", "free"])
def test_reproduce_matches_jax(case, rng):
    """One generation on 6 rows: the same children, the same pre-selection
    (``regularized``), the quaternion renormalization (``free``: the
    floating base's four genes), the same two survivors — within 1e-6."""
    n = 6
    jm, tm, js, ts = _pair(case)
    jd, genes, grads = _rows(jm, tm, js, rng, n)
    td = tree_from_numpy(jd, "cpu")
    x0 = genes[:, 0]
    tips0, deltas = _lin(ts, td, x0)
    keys = jax.random.split(jax.random.PRNGKey(rng.integers(1 << 30)), n)
    rate, noise, keep = _np(jax.vmap(lambda k: _j_reproduce_draws(k, genes.shape[-1]))(keys))
    jout = _np(jax.jit(jax.vmap(js.solver._reproduce))(
        keys, genes, grads, x0, tips0, deltas, jd))
    sv = ts.solver
    assert (len(sv.quat_slices) == 1) == (case == "free")
    tout = sv._reproduce(*(torch.from_numpy(a[:, None]) for a in (genes, grads, x0, tips0,
                                                                  deltas)),
                         _lead(td, 2), torch.from_numpy(rate[:, None]),
                         torch.from_numpy(noise[:, None]),
                         torch.from_numpy(keep[:, None]) if case == "regularized" else None)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t[:, 0].numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("memetic,case,spread", [
    ("q", "pose", 0.02), ("l", "pose", 0.02), ("q", "regularized", 0.05),
    ("l", "regularized", 0.2)])
def test_memetic_matches_jax(memetic, case, spread, rng):
    """The memetic phase on 16 rows in float64 (see the module docstring),
    within 1e-5, and its first gradient in float32 (autograd of the
    combined approximate fitness against ``jax.grad``), within 1e-5."""
    n = 16
    mode = {"q": "bio2_memetic", "l": "bio2_memetic_l"}[memetic]
    for dtype in ("float32", "float64"):
        with jax.enable_x64(dtype == "float64"):
            jm, tm, js, ts = _pair(case, mode, dtype)
            jd, genes, _ = _rows(jm, tm, js, rng, n, spread=spread)
            td = tree_from_numpy(jd, "cpu")
            x0, g0 = genes[:, 0], genes[:, 1]
            tips0, deltas = _lin(ts, td, x0)
            jp = js.problem
            tt = [torch.from_numpy(a[:, None]) for a in (g0, x0, tips0, deltas)]
            if dtype == "float32":
                def combined(x, x0_, t0_, dl_, d):
                    phen = t0_ + jnp.einsum("tvd,v->td", dl_, x - x0_)
                    return jp.fitness(phen, x, d) + jp.fitness_secondary(x, d)

                jgrad = np.asarray(jax.vmap(jax.grad(combined))(g0, x0, tips0, deltas, jd))
                _, _, tgrad = ts.solver._approx_grad(*tt, _lead(td, 1))
                np.testing.assert_allclose(tgrad[:, 0].numpy(), jgrad, rtol=1e-5, atol=1e-5)
                continue
            jmem = np.asarray(jax.jit(jax.vmap(lambda x, a, t, dl, d: js.solver._memetic(
                jax.random.PRNGKey(0), x, a, t, dl, d)))(g0, x0, tips0, deltas, jd))
            tmem = ts.solver._memetic(*tt, _lead(td, 1))[:, 0].numpy()
    assert tmem.dtype == np.float64
    assert (np.abs(jmem - g0).max(-1) > 1e-9).mean() >= 0.75  # the descent moved
    np.testing.assert_allclose(tmem, jmem, rtol=0, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("case,spread", [("pose", 0.02), ("regularized", 0.05)])
def test_memetic_lbfgs_matches_jax(case, spread, rng):
    """``bio2_memetic_lbfgs``'s memetic phase (8 L-BFGS updates with the
    zoom line search on the combined approximate fitness through the tied
    clip, then keep-if-better; JAX bio2.py:190-219) on 16 rows within 1e-8
    in float64.  ``slow``: the JAX phase compiles in ~10 s here."""
    n = 16
    with jax.enable_x64(True):
        jm, tm, js, ts = _pair(case, "bio2_memetic_lbfgs", "float64")
        jd, genes, _ = _rows(jm, tm, js, rng, n, spread=spread)
        td = tree_from_numpy(jd, "cpu")
        x0, g0 = genes[:, 0], genes[:, 1]
        tips0, deltas = _lin(ts, td, x0)
        jmem = np.asarray(jax.jit(jax.vmap(lambda x, a, t, dl, d: js.solver._memetic(
            jax.random.PRNGKey(0), x, a, t, dl, d)))(g0, x0, tips0, deltas, jd))
    tt = [torch.from_numpy(a[:, None]) for a in (g0, x0, tips0, deltas)]
    tmem = ts.solver._memetic(*tt, _lead(td, 1))[:, 0].numpy()
    assert (np.abs(jmem - g0).max(-1) > 1e-6).mean() >= 0.75   # the phase moved
    np.testing.assert_allclose(tmem, jmem, rtol=0, atol=1e-8)


_KIND_GOALS = {
    "position": lambda M: M.PositionGoal(link=TIP),
    "orientation": lambda M: M.OrientationGoal(link=TIP),
    "pose": lambda M: M.PoseGoal(link=TIP),
    "lookat": lambda M: M.LookAtGoal(link=TIP, axis=(1.0, 0.0, 0.0), target=(1.0, 0.2, 0.5)),
    "max_distance": lambda M: M.MaxDistanceGoal(link=TIP, target=(0.5, -0.2, 0.6),
                                                distance=0.2),
    "min_distance": lambda M: M.MinDistanceGoal(link=TIP, target=(0.5, -0.2, 0.6),
                                                distance=0.6),
    "line": lambda M: M.LineGoal(link=TIP, position=(0.5, -0.2, 0.6),
                                 direction=(0.0, 0.6, 0.8)),
    "plane": lambda M: M.PlaneGoal(link=TIP, position=(0.5, -0.2, 0.6),
                                   normal=(0.0, 0.0, 1.0)),
    "side": lambda M: M.SideGoal(link=TIP, axis=(0.0, 0.0, 1.0), direction=(1.0, 0.0, 0.0)),
    "direction": lambda M: M.DirectionGoal(link=TIP, axis=(0.0, 0.0, 1.0),
                                           direction=(1.0, 0.0, 0.0)),
    "cone": lambda M: M.ConeGoal(link=TIP, axis=(0.0, 0.0, 1.0), direction=(1.0, 0.0, 0.0),
                                 angle=0.3, position=(0.5, -0.2, 0.6), position_weight=0.5),
    # the kinds only the island path evaluates; the function goals in the
    # goals module's own tensor library
    "touch": lambda M: M.TouchGoal(link="r_wrist_roll_link", position=(0.5, -0.2, 0.6),
                                   normal=(0.0, 0.3, 1.0)),
    "balance": lambda M: M.BalanceGoal(target=(0.2, -0.1, 0.0), axis=(0.0, 0.1, 1.0)),
    "link_function": lambda M: M.LinkFunctionGoal(link=TIP, function=_link_fn(M)),
    "joint_function": lambda M: M.JointFunctionGoal(
        variable_names=("r_shoulder_pan_joint", "r_elbow_flex_joint"),
        function=lambda v: 0.5 * (v + 0.3)),
}


def _link_fn(M):
    xp, s = (jnp, {"axis": -1}) if M is JG else (torch, {"dim": -1})
    return lambda p, q: xp.sum((p - 0.4) * p, **s) + 0.1 * q[..., 0] * q[..., 3]


@pytest.fixture(scope="module")
def every_kind():
    """One PR2 problem with a primary goal of every kind the island path
    evaluates (one group each) and three joint-space secondary goals; the
    JAX gradient of its combined approximate fitness, jitted once; 8 rows
    of inputs, half with the linearization point on the parents
    themselves."""
    jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")

    def goals(M):
        return [_KIND_GOALS[k](M) for k in sorted(_KIND_GOALS)] + [
            M.CenterJointsGoal(weight=0.2, secondary=True),
            M.RegularizationGoal(weight=0.1, secondary=True),
            M.JointVariableGoal(variable_name=tm.var_names[2], variable_position=0.3,
                                secondary=True)]

    cfg = dict(mode="bio2_memetic", fused="off")
    js = JIKSolver(jm, goals(JG), JSolverConfig(**cfg))
    ts = IKSolver(tm, goals(G), SolverConfig(**cfg))
    assert [g.kind for g in ts.problem.primary] == sorted(_KIND_GOALS)
    n = 8
    jd, genes, _ = _rows(jm, tm, js, np.random.default_rng(21), n, spread=0.1)
    x0 = genes[:, 0].copy()
    x0[n // 2:] = genes[n // 2:, 1]
    tips0, deltas = _lin(ts, tree_from_numpy(jd, "cpu"), x0)
    jp = js.problem

    def combined(x, x0_, t0_, dl_, d):
        phen = t0_ + jnp.einsum("tvd,v->td", dl_, x - x0_)
        return jp.fitness(phen, x, d) + jp.fitness_secondary(x, d)

    return ts, jd, (genes[:, 1], x0, tips0, deltas), jax.jit(jax.vmap(jax.grad(combined)))


@pytest.mark.parametrize("kind", sorted(_KIND_GOALS))
def test_gradient_of_every_goal_kind_matches_jax(kind, every_kind):
    """The memetic gradient through ``Problem.fitness`` of each primary kind
    (the other kinds' weights at 0) with the secondary kinds beside it:
    finite on every row and equal to ``jax.grad`` within 1e-5 wherever the
    JAX gradient is finite."""
    ts, jd, args, jgrad_fn = every_kind
    jd = jax.tree.map(np.copy, jd)
    for gi, grp in enumerate(ts.problem.primary):
        if grp.kind != kind:
            jd["primary"][gi]["weight_sq"][:] = 0.0
    jgrad = np.asarray(jgrad_fn(*args, jd))
    tt = [torch.from_numpy(a[:, None]) for a in args]
    _, _, tgrad = ts.solver._approx_grad(*tt, _lead(tree_from_numpy(jd, "cpu"), 1))
    tgrad = tgrad[:, 0].numpy()
    assert np.isfinite(tgrad).all() and np.abs(tgrad).max() > 0
    fin = np.isfinite(jgrad).all(-1)
    assert fin.sum() >= len(fin) // 2
    np.testing.assert_allclose(tgrad[fin], jgrad[fin], rtol=1e-5, atol=1e-5)


def _j_step_draws(key, gens, V):
    """JAX Bio2Solver.step's draws (bio2.py:255-307): per species a chain of
    ``gens`` key splits, each generation's ``_reproduce`` draws, then the
    wipe coin and restart genes — as ``(rate (gens, S, C), noise (gens, S,
    C, V), keep (gens, S), wipe_u (S,), wipe_g (S, V))``."""
    key, k_species, k_wipe_p, k_wipe_g = jax.random.split(key, 4)

    def gen(kk, _):
        kk, kg = jax.random.split(kk)
        return kk, _j_reproduce_draws(kg, V)

    _, per = jax.vmap(lambda kk: jax.lax.scan(gen, kk, None, length=gens))(
        jax.random.split(k_species, 2))
    return (*(jnp.swapaxes(a, 0, 1) for a in per),
            jax.random.uniform(k_wipe_p, (2,)),
            jax.random.uniform(k_wipe_g, (2, V), jnp.float32))


def test_step_bookkeeping_matches_jax(rng):
    """One whole ``step`` (bio2, 16 generations) on two islands with the JAX
    step's draws — one island's coin wipes its second species, the other's
    does not (keys chosen by that coin): species sort, wipeout, incumbent;
    genes, gradients, fitnesses within 1e-5."""
    jm, tm, js, ts = _pair("pose", "bio2")
    jd, genes, grads = _rows(jm, tm, js, rng, 2)
    td = tree_from_numpy(jd, "cpu")
    sv = js.solver
    cand = jax.random.split(jax.random.PRNGKey(17), 64)
    coin = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k, 4)[2], (2,)))(cand))[:, 1]
    keys = cand[np.asarray([np.argmax(coin < 0.1), np.argmax(coin >= 0.1)])]
    jst = JBio2State(key=keys, genes=jnp.asarray(np.stack([genes, genes[:, ::-1]], 1)),
                     grads=jnp.asarray(np.stack([grads] * 2, 1)),
                     species_fitness=jnp.asarray(rng.uniform(0, 1, (2, 2)), jnp.float32),
                     solution=jnp.asarray(genes[:, 1, :]),
                     solution_fitness=jnp.asarray([1.0, 1e-9], jnp.float32))
    V = genes.shape[-1]
    dr = _np(jax.jit(jax.vmap(lambda k: _j_step_draws(k, sv.generations, V)))(keys))
    jout = _np(jax.jit(jax.vmap(sv.step))(jst, jd))
    tst = ts.solver.init(torch.Generator(), td)._replace(**{
        f: torch.from_numpy(np.array(getattr(jst, f)))
        for f in ("genes", "grads", "species_fitness", "solution", "solution_fitness")})
    draws = Bio2Draws(*(torch.from_numpy(np.moveaxis(a, 0, 1)) for a in dr[:2]), None,
                      torch.from_numpy(dr[3]), torch.from_numpy(dr[4]))
    tout = ts.solver.step(tst, td, draws)
    for name in ("genes", "grads", "species_fitness", "solution", "solution_fitness"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), getattr(jout, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the wiped island's second species restarted at the draw's genes
    wiped = np.asarray(ts.problem.amin + torch.from_numpy(dr[4][0, 1])
                       * (ts.problem.amax - ts.problem.amin))
    np.testing.assert_allclose(jout.genes[0, 1, 0], wiped, atol=1e-6)


# ---------------------------------------------------------------------------
# port-only: the island path's entry points


@pytest.mark.parametrize("mode", ["bio2", "bio2_memetic", "bio2_memetic_l"])
def test_island_modes_and_migration_run(mode):
    """``solve`` and ``solve_until`` for each mode, ``elite_migration`` on
    the island path: a fixed key gives a fixed result."""
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    for migrate in (False, True):
        s = IKSolver(m, [G.PoseGoal(link=TIP)],
                     SolverConfig(mode=mode, dtwist=1e-3, max_steps=2, steps_per_check=1,
                                  islands=2, elite_migration=migrate))
        assert (s.engine is None) == migrate
        seed = torch.as_tensor(m.neutral_q())
        r1, r2 = s.solve(seed, key=[0, 7]), s.solve(seed, key=[0, 7])
        assert torch.equal(r1.q, r2.q) and r1.q.shape == (m.nvars,)
        assert not torch.equal(r1.q, s.solve(seed, key=[0, 8]).q)
        assert s.solve_until(seed).q.shape == (m.nvars,)


def test_inject_takes_the_migrant():
    """``inject`` puts the migrant in the last species' second parent and
    takes it as incumbent where it is better (JAX bio2.py:331-340)."""
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(fused="off"))
    data = tree_map(lambda x: x.expand((3,) + x.shape).clone(),
                    s.make_data(torch.as_tensor(m.neutral_q())))
    st = s.solver.init(torch.Generator(), data)
    qa = torch.full((3, 7), 0.1)
    fit = torch.tensor([0.0, 1e9, 0.0])
    out = s.solver.inject(st, qa, fit)
    assert torch.equal(out.genes[:, 1, 1], qa) and torch.equal(out.genes[:, 0], st.genes[:, 0])
    assert torch.equal(out.solution[1], st.solution[1]) and torch.equal(out.solution[0], qa[0])
    assert torch.equal(out.solution_fitness, torch.minimum(fit, st.solution_fitness))


@pytest.mark.slow
def test_island_solve_matches_jax_on_eight_targets():
    """The island ``solve`` of both packages on 8 PR2 targets 0.3 rad about
    the seed (PoseGoal, dtwist 1e-3, 2 islands, 8 steps): the port's
    successes ≥ the JAX package's − 2 and the medians of the position error
    within 10× (about 90 s on a CPU, most of it the JAX solve)."""
    n = 8
    jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    b = tm._np_bounds
    q = np.clip(tm.neutral_q() + np.random.default_rng(4).uniform(-0.3, 0.3, (n, 7)),
                b["min"], b["max"]).astype(np.float32)
    cfg = dict(mode="bio2_memetic", dtwist=1e-3, max_steps=8, islands=2, fused="off")
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)], JSolverConfig(**cfg))
    ts = IKSolver(tm, [G.PoseGoal(link=TIP)], SolverConfig(**cfg))
    jfk, tfk = j_make_fk(jm, [TIP]), make_fk(tm, [TIP])
    tg = jfk(jnp.asarray(q))
    out = {}
    for side in ("jax", "port"):
        ok, err = 0, []
        for i in range(n):
            if side == "jax":
                d = js.make_data(jnp.asarray(jm.neutral_q()))
                d["primary"][0]["position"], d["primary"][0]["orientation"] = \
                    tg.pos[i], tg.quat[i]
                r = js.solve(jnp.asarray(jm.neutral_q()), key=jax.random.PRNGKey(i), data=d)
                pos = np.asarray(jfk(r.q[None]).pos)[0, 0]
            else:
                d = ts.make_data(torch.as_tensor(tm.neutral_q()))
                d["primary"][0]["position"] = torch.from_numpy(np.array(tg.pos[i]))
                d["primary"][0]["orientation"] = torch.from_numpy(np.array(tg.quat[i]))
                r = ts.solve(torch.as_tensor(tm.neutral_q()), key=[0, i], data=d)
                pos = tfk(r.q[None]).pos[0, 0].numpy()
            ok += bool(r.success)
            err.append(np.linalg.norm(pos - np.asarray(tg.pos)[i, 0]))
        out[side] = (ok, float(np.median(err)))
    print(out)
    assert out["port"][0] >= out["jax"][0] - 2
    lo, hi = sorted([out["port"][1], out["jax"][1]])
    assert hi <= 10 * max(lo, 1e-7)
