"""The island path's other solvers — gd, jac, test and bio1 — against the
JAX package (CPU).

Each port function is fed the JAX function's own draws, recreated here
with the same ``jax.random`` calls, and held to the JAX outputs on the
same inputs (made with numpy from a seed, carried across with
``interop``):

  * gd (``slow``): one ``step`` of ``gd``, ``gd_r`` and ``gd_c``, rows
    with and without a pending restart — in float64 on both sides within
    1e-8; in float32 within 2e-2 in the configuration and the fitness (the
    line probe divides the difference of two fitnesses a probe length
    apart, ~1e-4 of each other, so the packages' last-bit FK differences
    move the step by a large share of its length);
  * jac (``slow``): one ``step`` within 1e-5 at 16 configurations of the
    PR2 arm (its 6 × 7 system) and at one rank-deficient configuration
    (three colinear roll axes; the rank read off the SVD of JAX's J);
  * test (``slow``): the linearizer's mean position and rotation errors
    over the same 64 probes within 1e-6;
  * bio1: the heuristic errors, extinctions, rerolls, both fitness modes,
    ``_reproduce``, and (``slow``) ``_exploit`` and one whole ``step`` (the
    children's loop, the sort, the solution update and the wipeout) within
    1e-6, on a 3-joint arm (the JAX package's eager FK costs ~0.2 s a call
    here); the triangular parent pick's distribution by a chi-square test;
    and the rotation distance at small angles, where the port parts from
    the JAX package's float32 arccos (``solvers/bio1.py``).

The ``slow`` comparisons each compile a JAX program of several seconds on
a CPU; the default tier compiles two: bio1's helpers and the end-to-end
``jac`` solve.
The slice end to end: one JAX ``jac`` solve with one island (deterministic)
against the port's on 4 PR2 targets at 8 steps, q within 1e-4 and equal
success, with ``counter=True`` on both sides: equal ``SolveStats``
summaries.  Port-only: bio1, gd_c in float64 and jac lower the median
position error of 8 targets from the seed's.
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
from bio_ik_tpu.solvers.bio1 import Bio1State as JBio1State
from bio_ik_tpu.solvers.gd import GDState as JGDState
from bio_ik_tpu.solvers.jac import JacState as JJacState

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map
from bio_ik_tpu_torch.math.frame import Frame
from bio_ik_tpu_torch.solvers.bio1 import Bio1Draws, _triangular_pick
from bio_ik_tpu_torch.solvers.bio2 import _lead

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
# a 3-joint arm: the JAX package's FK is eager per op here, ~0.2 s a call
ARM3 = """<robot name="arm3"><link name="base"/><link name="l1"/><link name="l2"/>
<link name="tool"/>
<joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
<origin xyz="0 0 0.3"/><axis xyz="0 0 1"/><limit lower="-3" upper="3" velocity="1"/></joint>
<joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
<origin xyz="0 0 0.4"/><axis xyz="0 1 0"/><limit lower="-2" upper="2" velocity="2"/></joint>
<joint name="j3" type="revolute"><parent link="l2"/><child link="tool"/>
<origin xyz="0.4 0 0.05"/><axis xyz="1 0 0"/><limit lower="-3" upper="3" velocity="1"/></joint>
</robot>"""


def _np(tree):
    return jax.tree.map(np.array, tree)


def _pair(robot, mode, goals=None, **cfg):
    """The JAX and the port's island solvers of one problem (CPU):
    ``robot`` is "arm3" or a URDF asset; one PoseGoal on its tip by
    default."""
    if robot == "arm3":
        jm, tm = JRobotModel.from_urdf_string(ARM3), RobotModel.from_urdf_string(
            ARM3, device="cpu")
        tip = "tool"
    else:
        jm = JRobotModel.from_urdf_file(asset_path(robot))
        tm = RobotModel.from_urdf_file(asset_path(robot), device="cpu")
        tip = TIP
    goals = goals or (lambda M: [M.PoseGoal(link=tip)])
    cfg = dict(mode=mode, dtwist=1e-3, fused="off", **cfg)
    return (jm, tm, JIKSolver(jm, goals(JG), JSolverConfig(**cfg)),
            IKSolver(tm, goals(G), SolverConfig(**cfg)))


def _rows(jm, tm, js, rng, n, spread=0.1):
    """n rows of one problem in its dtype: the JAX data (pose targets at
    FK of q*) and configurations about q*."""
    dt = js.problem.dtype
    b = tm._np_bounds
    qs = rng.uniform(b["min"] * 0.6, b["max"] * 0.6, (n, tm.nvars)).astype(dt)
    tg = make_fk(tm, js.problem.tip_links)(torch.from_numpy(qs))
    d0 = js.make_data(jnp.asarray(jm.neutral_q()))
    jd = _np(jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0))
    for gi, grp in enumerate(js.problem.primary):
        for k, v in (("position", tg.pos), ("orientation", tg.quat)):
            if k in jd["primary"][gi]:
                jd["primary"][gi][k] = v.numpy()[:, grp.tip_slots]
    jd = jax.tree.map(lambda a: a.astype(dt) if a.dtype.kind == "f" else a, jd)
    av = np.asarray(js.problem.active_vars)
    q = (qs[:, av] + rng.normal(0, spread, (n, len(av)))).astype(dt)
    return jd, np.clip(q, b["min"][av], b["max"][av]).astype(dt)


def _keys(rng, n):
    return jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), n)


# ---------------------------------------------------------------------------
# gd


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gd_step_matches_jax(dtype, rng):
    """One step of gd, gd_r and gd_c on 8 rows of the 3-joint arm, 4 of
    them with a pending restart, fed JAX's restart draws (gd.py:60-66):
    the configuration, fitness, best and restart flag (module
    docstring's tolerances).  JAX runs the three steps as one jitted
    program (~6 s to compile here, hence ``slow``)."""
    n = 8
    qtol, ftol = (1e-8, 1e-8) if dtype == "float64" else (2e-2, 2e-2)
    modes = ("gd", "gd_r", "gd_c")
    with jax.enable_x64(dtype == "float64"):
        pairs = [_pair("arm3", mode, dtype=dtype) for mode in modes]
        jm, tm, js, _ = pairs[0]
        jd, q = _rows(jm, tm, js, rng, n)
        td = tree_from_numpy(jd, "cpu")
        keys = _keys(rng, n)
        # the rows' fitness, an input of both steps
        f = pairs[0][3].ctx.fitness_exact(torch.from_numpy(q), td).numpy()
        reset = np.arange(n) % 2 == 1
        jst = JGDState(key=keys, qa=q, fitness=f, best=q, best_fitness=f * 2, reset=reset)
        jouts = _np(jax.jit(lambda st, d: [jax.vmap(p[2].solver.step)(st, d)
                                           for p in pairs])(jst, jd))
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k)[1], (q.shape[-1],), js.problem.amin.dtype))(keys))
    for mode, (_, _, _, ts), jout in zip(modes, pairs, jouts):
        tst = ts.solver.init(torch.Generator(), td, torch.zeros(n, dtype=torch.bool))
        tst = tst._replace(qa=torch.tensor(q), fitness=torch.tensor(f), best=torch.tensor(q),
                           best_fitness=torch.tensor(f * 2), reset=torch.tensor(reset))
        tout = ts.solver.step(tst, td, rand_u=torch.tensor(u))
        assert tout.qa.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        assert (np.abs(jout.qa - q).max(-1) > 1e-7).sum() >= n // 2, mode
        for name, tol in (("qa", qtol), ("best", qtol), ("fitness", ftol),
                          ("best_fitness", ftol)):
            np.testing.assert_allclose(getattr(tout, name).numpy(), getattr(jout, name),
                                       rtol=0, atol=tol, err_msg=f"{mode} {name}")
        np.testing.assert_array_equal(tout.reset.numpy(), jout.reset, err_msg=mode)


# ---------------------------------------------------------------------------
# jac


@pytest.mark.slow
def test_jac_step_matches_jax(rng):
    """One jac step at 16 PR2 configurations (the 6 × 7 system, solved for
    its minimum-norm solution) and one rank-deficient one: the upper-arm,
    forearm and wrist roll axes colinear through the tool frame (elbow and
    wrist flex at 0), rank 4 by the SVD of JAX's J.  ``slow``: the JAX step
    and Jacobian compile in ~5 s here; the default tier holds jac through
    the end-to-end solve below."""
    n = 16
    jm, tm, js, ts = _pair("pr2_arm.urdf", "jac")
    jd, q = _rows(jm, tm, js, rng, n + 1)
    q[n] = 0.0
    q[n, 0], q[n, 1] = 0.3, 0.2
    jst = JJacState(key=_keys(rng, n + 1), qa=q)
    jout, J = jax.jit(lambda st, d: (
        jax.vmap(js.solver.step)(st, d).qa,
        jax.vmap(js.ctx.jacobian)(js.ctx.qfull(d["seed_full"], st.qa))[1]))(jst, jd)
    jout = np.asarray(jout)
    s = np.linalg.svd(np.asarray(J[n]).reshape(-1, 7), compute_uv=False)
    rank = (s > s[0] * 1e-5).sum()
    assert rank < 6 and (s > s[0] * 1e-3).sum() == rank
    tout = ts.solver.step(ts.solver.init(torch.Generator(), tree_from_numpy(jd, "cpu"),
                                         torch.zeros(n + 1, dtype=torch.bool))
                          ._replace(qa=torch.from_numpy(q)), tree_from_numpy(jd, "cpu"))
    assert (np.abs(jout - q).max(-1) > 1e-4).all()
    np.testing.assert_allclose(tout.qa.numpy(), jout, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# test mode


@pytest.mark.slow
def test_testmode_errors_match_jax(rng, capsys):
    """The linearizer's mean errors over JAX's 64 probes (testmode.py:57-59)
    at 4 seeds of the 3-joint arm within 1e-6, in float64 on both sides
    (in float32 the rotation error, an arccos near 1 of the approximate
    and exact quaternions' dot, carries their last-bit differences up to
    ~2e-5), and the printed line.  ``slow``: JAX's init compiles in ~4 s
    here."""
    n = 4
    with jax.enable_x64(True):
        jm, tm, js, ts = _pair("arm3", "test", dtype="float64")
        jd, q = _rows(jm, tm, js, rng, n, spread=0.5)
        jd["seed_full"], jd["seed_active"] = q, q
        keys = _keys(rng, n)
        jst = jax.jit(jax.vmap(lambda k, d: js.solver.init(k, d, False)))(keys, jd)
        dq = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (64, 3), jnp.float64, -0.1, 0.1))(keys))
    tst = ts.solver.init(torch.Generator(), tree_from_numpy(jd, "cpu"), dq=torch.tensor(dq))
    assert "ik test: mean dpos" in capsys.readouterr().out
    assert float(np.min(jst.pos_err)) > 1e-4
    for name in ("pos_err", "rot_err", "fitness"):
        np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert ts.solver.step(tst, None) is tst


# ---------------------------------------------------------------------------
# bio1


@pytest.fixture(scope="module")
def bio1_case():
    """The 3-joint arm under bio1 (population 4, 2 elites) in both fitness
    modes, 6 rows of data and configurations."""
    rng = np.random.default_rng(31)
    out = {}
    for lin in (False, True):
        jm, tm, js, ts = _pair("arm3", "bio1", population_size=4, elite_count=2,
                               linear_fitness=lin)
        out[lin] = (js, ts)
    jd, q = _rows(jm, tm, js, rng, 6, spread=0.3)
    return out, jd, q


@pytest.fixture(scope="module")
def bio1_parts(bio1_case):
    """Inputs of the bio1 helpers and the JAX package's outputs on them,
    computed as one jitted program: the heuristic errors at the port's tip
    frames, the extinctions, rerolls on keys, ``_reproduce`` on given
    uniforms (its draw replaced), and the fitness in both modes (balanced,
    and on JAX's random weights); with the draws each JAX function took."""
    (modes, jd, q) = bio1_case
    (js, ts), (jl, _) = modes[False], modes[True]
    rng = np.random.default_rng(32)
    n, E = q.shape[0], 2
    tips = ts.ctx.tips_frame(torch.from_numpy(jd["seed_full"]), torch.from_numpy(q))
    inp = dict(
        pos=tips.pos.numpy(), quat=tips.quat.numpy(), q=q,
        fit=np.sort(rng.uniform(0.01, 2.0, (n, 4)).astype(np.float32), axis=-1),
        keys=_keys(rng, n), r=rng.uniform(size=(n, 9, 3)).astype(np.float32),
        grads=rng.normal(0, 0.01, (n, 3, 3)).astype(np.float32),
        genes=(q[:, None] + rng.normal(0, 0.05, (n, E, 3))).astype(np.float32),
        egrads=rng.normal(0, 0.01, (n, E, 3)).astype(np.float32))
    jsv, jlv = js.solver, jl.solver
    Fr = type(js.ctx.tips_frame(jd["seed_full"][0], q[0]))

    def reproduce(rr, *a):
        # JAX _reproduce with its uniform draw replaced by ``rr``
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda *_a, **_k: rr)
            return jsv._reproduce(jax.random.PRNGKey(0), *a, None)

    def split_u(k, shape):
        return [jax.random.uniform(x, shape) for x in jax.random.split(k)]

    def run(x, d):
        out = dict(
            he=jax.vmap(jsv._heuristic_errors)(Fr(x["pos"], x["quat"]), d),
            ext=jax.vmap(jsv._extinctions)(x["fit"]),
            reroll=jax.vmap(jsv._reroll)(x["keys"], x["q"]),
            reroll_ut=jax.vmap(lambda k: jnp.stack(split_u(k, (3,))))(x["keys"]),
            f_std=jax.vmap(jsv._fitness)(x["q"], d),
            f_bal=jax.vmap(jlv._fitness)(x["q"], d),
            f_rand=jax.vmap(lambda g, dd, k: jlv._fitness(g, dd, key=k, balanced=False))(
                x["q"], d, x["keys"]),
            w=jax.vmap(lambda k: jax.random.uniform(k, (1,)))(x["keys"]))
        g = x["grads"]
        out["reproduce"] = jax.vmap(reproduce)(
            x["r"], x["q"], g[:, 0], x["fit"][:, 1], jnp.roll(x["q"], 1, 0), g[:, 1],
            x["fit"][:, 2], jnp.roll(x["q"], 2, 0), g[:, 2])
        return out

    return inp, _np(jax.jit(run)(inp, jd))


def test_bio1_tables_and_helpers_match_jax(bio1_case, bio1_parts):
    """The heuristic-error tables and errors at the port's tip frames, the
    extinction factors, rerolls on JAX's draws and ``_reproduce`` on given
    uniforms, within 1e-6."""
    (modes, jd, q), (inp, jo) = bio1_case, bio1_parts
    (js, ts) = modes[False]
    jsv, tsv = js.solver, ts.solver
    for name, tname in (("influence", "influence_t"), ("chain_len", "chain_len"),
                        ("chain_len2", "chain_len2")):
        jv = np.asarray(getattr(jsv, name))
        np.testing.assert_allclose(getattr(tsv, tname).numpy(),
                                   jv.T if name == "influence" else jv, atol=1e-7)
    td = tree_from_numpy(jd, "cpu")
    tips = Frame(torch.from_numpy(inp["pos"]), torch.from_numpy(inp["quat"]))
    np.testing.assert_allclose(tsv._heuristic_errors(tips, td).numpy(), jo["he"], atol=1e-6)
    assert np.abs(jo["he"]).max() > 1e-3
    np.testing.assert_allclose(tsv._extinctions(torch.from_numpy(inp["fit"])).numpy(),
                               jo["ext"], atol=1e-6)
    u, t = (torch.from_numpy(jo["reroll_ut"][:, i]) for i in (0, 1))
    np.testing.assert_allclose(tsv._reroll(u, t).numpy(), jo["reroll"], atol=1e-6)
    g, fit = torch.from_numpy(inp["grads"]), torch.from_numpy(inp["fit"])
    tq = torch.from_numpy(q)
    trep = tsv._reproduce(tq, g[:, 0], fit[:, 1], tq.roll(1, 0), g[:, 1], fit[:, 2],
                          tq.roll(2, 0), g[:, 2],
                          torch.from_numpy(np.moveaxis(inp["r"], 1, 0)))
    for a, b in zip(trep, jo["reproduce"]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


@pytest.mark.parametrize("linear", [False, True])
def test_bio1_fitness_matches_jax(linear, bio1_case, bio1_parts):
    """The standard fitness, and with ``linear_fitness`` the balanced and
    the random-weight mixes on JAX's weights, within 1e-6."""
    (modes, jd, q), (inp, jo) = bio1_case, bio1_parts
    ts = modes[linear][1]
    td = tree_from_numpy(jd, "cpu")
    tq = torch.from_numpy(q)
    if not linear:
        np.testing.assert_allclose(ts.solver._fitness(tq, td).numpy(), jo["f_std"],
                                   rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_allclose(ts.solver._fitness(tq, td).numpy(), jo["f_bal"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.solver._fitness(tq, td, torch.from_numpy(jo["w"])).numpy(),
                               jo["f_rand"], rtol=1e-6, atol=1e-6)
    assert np.abs(jo["f_rand"] - jo["f_bal"]).max() > 1e-4


@pytest.mark.slow
def test_bio1_exploit_matches_jax(bio1_case, bio1_parts):
    """The greedy per-variable ``_exploit`` of two elites a row, on JAX's
    uniforms (bio1.py:387-432): genes, gradients and mean fitness within
    1e-6, and the elites moved.  ``slow``: JAX's exploit compiles in ~4 s
    here."""
    (modes, jd, q), (inp, _) = bio1_case, bio1_parts
    js, ts = modes[False]
    jsv, tsv = js.solver, ts.solver
    E = inp["genes"].shape[1]
    jo = _np(jax.jit(lambda x, d: dict(
        exploit=jax.vmap(jax.vmap(jsv._exploit, (0, 0, 0, None)))(
            jax.vmap(lambda k: jax.random.split(k, E))(x["keys"]), x["genes"],
            x["egrads"], d),
        exploit_u=jax.vmap(lambda k: jnp.stack([jnp.stack([
            jnp.stack([jax.random.uniform(kk) for kk in jax.random.split(kv, 3)])
            for kv in jax.random.split(ke, 3)]) for ke in jax.random.split(k, E)]))(
            x["keys"])))(inp, jd))
    draws = torch.from_numpy(np.moveaxis(jo["exploit_u"], (0, 1, 2, 3), (2, 3, 0, 1)))
    tex = tsv._exploit(torch.from_numpy(inp["genes"]), torch.from_numpy(inp["egrads"]),
                       _lead(tree_from_numpy(jd, "cpu"), 1), draws)
    for a, b in zip(tex, jo["exploit"]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert np.abs(jo["exploit"][0] - inp["genes"]).max() > 1e-4


def test_bio1_rotation_distance_sees_small_angles(bio1_case):
    """bio1's rotation distance (``quat_angle_atan2``) at goal-to-tip
    rotations of 0.05–2 mrad with both quaternions' norms 1 + 1.5e-7 in
    float32, as FK's rounding leaves them: within 2e-5 rad of the exact
    angle, where the JAX package's clamped arccos reads 0 for most of them;
    at 0.05–3 rad within 1e-6 of the exact angle."""
    from bio_ik_tpu_torch.math.quat import quat_angle_shortest, quat_from_axis_angle, quat_mul

    (modes, jd, q) = bio1_case
    tsv = modes[True][1].solver
    td = tree_from_numpy(jd, "cpu")
    n = q.shape[0]
    rng = np.random.default_rng(33)
    gq = torch.from_numpy(jd["primary"][0]["orientation"][:, 0]).double()
    axis = torch.from_numpy(rng.normal(size=(n, 3)))
    axis = axis / axis.norm(dim=-1, keepdim=True)
    theta = torch.from_numpy(rng.uniform(5e-5, 2e-3, n))
    tq = quat_mul(gq, quat_from_axis_angle(axis, theta))
    scale = 1 + 1.5e-7
    gq32, tq32 = (gq * scale).float(), (tq * scale).float()
    td["primary"][0]["orientation"] = gq32[:, None]
    tips = Frame(torch.zeros(n, 1, 3), tq32[:, None])
    rot = tsv._distances(tips, td)[1][:, 0].double()
    np.testing.assert_allclose(rot.numpy(), theta.numpy(), rtol=0, atol=2e-5)
    assert (quat_angle_shortest(tq32, gq32) == 0).double().mean() > 0.5
    far = torch.from_numpy(rng.uniform(0.05, 3.0, n))
    tq = quat_mul(gq, quat_from_axis_angle(axis, far)).float()
    tips = Frame(torch.zeros(n, 1, 3), tq[:, None])
    np.testing.assert_allclose(tsv._distances(tips, td)[1][:, 0].numpy(), far.numpy(),
                               rtol=0, atol=1e-6)


def _j_bio1_step_draws(key, N, E, V, G):
    """JAX Bio1Solver.step's draws (bio1.py:296-405), in the port's
    ``Bio1Draws`` layout for one row."""
    u = jax.random.uniform
    key, k_ex, k_ch, k_wp, k_init = jax.random.split(key, 5)
    ex = []
    for ek in jax.random.split(k_ex, E):
        ex.append(jnp.stack([jnp.stack([u(kk) for kk in jax.random.split(k, 3)])
                             for k in jax.random.split(ek, V)]))
    ch = {n: [] for n in ("gumbel", "repro", "cw", "ru", "rt", "rw")}
    k = k_ch
    for _ in range(N - E):
        k, ka, kb, kp, kr, krr, kf, kf2 = jax.random.split(k, 8)
        ch["gumbel"].append(jnp.stack([jax.random.gumbel(x, (N,)) for x in (ka, kb, kp)]))
        ch["repro"].append(u(kr, (9, V)))
        ch["cw"].append(u(kf, (G,)))
        k1, k2 = jax.random.split(krr)
        ch["ru"].append(u(k1, (V,)))
        ch["rt"].append(u(k2, (V,)))
        ch["rw"].append(u(kf2, (G,)))
    kp1, kp2 = jax.random.split(k_wp)
    k_roll, k_fit = jax.random.split(k_init)
    pk = [jax.random.split(x) for x in jax.random.split(k_roll, N)]
    return (jnp.stack(ex).transpose(1, 2, 0), *(jnp.stack(ch[n]) for n in ch),
            u(kp1, (V,)), u(kp2, (V,)), jnp.stack([u(a, (V,)) for a, _ in pk]),
            jnp.stack([u(b, (V,)) for _, b in pk]),
            jnp.stack([u(x, (G,)) for x in jax.random.split(k_fit, N)]))


def _bio1_draws(rows, linear):
    """``Bio1Draws`` from JAX draws with a leading row axis."""
    ex, gum, rep, cw, ru, rt, rw, wu, wd, pu, pt, pw = rows
    t = torch.from_numpy
    return Bio1Draws(
        exploit=t(np.moveaxis(ex, 0, 2)), gumbel=t(np.moveaxis(gum, 0, 2)),
        repro=t(np.moveaxis(rep, 0, 2)), child_w=t(np.moveaxis(cw, 0, 1)) if linear else None,
        reroll_u=t(np.moveaxis(ru, 0, 1)), reroll_t=t(np.moveaxis(rt, 0, 1)),
        reroll_w=t(np.moveaxis(rw, 0, 1)) if linear else None, wipe_up=t(wu), wipe_down=t(wd),
        pop_u=t(pu), pop_t=t(pt), pop_w=t(pw) if linear else None)


@pytest.mark.slow
@pytest.mark.parametrize("linear", [False, True])
def test_bio1_step_matches_jax(linear, bio1_case, rng):
    """One whole ``step`` on JAX's draws (6 rows from the port's ``init``,
    the incumbent of half of them unbeatable, so that their wipeout check
    decides): the children's loop, the sort, the solution update and the
    wipeout — the population, fitness, extinctions and solution within
    1e-6.  ``slow``: the JAX step's compile takes ~15 s here."""
    (modes, jd, q) = bio1_case
    js, ts = modes[linear]
    jsv, tsv = js.solver, ts.solver
    td = tree_from_numpy(jd, "cpu")
    n, N, E, V, G = 6, jsv.N, jsv.elites, 3, 1
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    st0 = tsv.init(g, td)
    st0 = st0._replace(grads=st0.grads + 0.01, solution=torch.where(
        (torch.arange(n) % 2 == 0)[:, None], torch.from_numpy(q), st0.genes[:, -1]))
    keys = _keys(rng, n)
    jst = JBio1State(key=keys, **{f: getattr(st0, f).numpy() for f in
                                  ("genes", "grads", "fitness", "extinction", "solution")})
    jout = _np(jax.jit(jax.vmap(jsv.step))(jst, jd))
    dr = _bio1_draws(_np(jax.vmap(lambda k: _j_bio1_step_draws(k, N, E, V, G))(keys)),
                     linear)
    tout = tsv.step(st0, td, dr)
    for name in ("genes", "grads", "fitness", "extinction", "solution"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), getattr(jout, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    kept = np.all(jout.solution == st0.solution.numpy(), axis=-1)
    assert kept.any() and not kept.all()


def test_triangular_pick_distribution():
    """20 000 picks from a fixed pool of 5 among 8: P(rank j) ∝ na − j among
    the members, never a non-member (chi-square, 4 degrees of freedom, p ≈
    0.001 at 18.5)."""
    g = torch.Generator().manual_seed(3)
    n = 20000
    mask = torch.tensor([True, False, True, True, False, True, False, True]).expand(n, 8)
    gumbel = -torch.log(torch.empty((n, 8)).exponential_(generator=g))
    idx = _triangular_pick(gumbel, mask)
    counts = torch.bincount(idx, minlength=8).numpy()
    members = np.flatnonzero(mask[0].numpy())
    assert counts[~mask[0].numpy()].sum() == 0
    p = np.arange(5, 0, -1) / 15.0
    chi2 = float(np.sum((counts[members] - n * p) ** 2 / (n * p)))
    assert chi2 < 18.5, (counts, chi2)
    assert int(_triangular_pick(gumbel[:1], torch.zeros((1, 8), dtype=torch.bool))) == 0


# ---------------------------------------------------------------------------
# the slice end to end


def test_jac_solve_matches_jax_end_to_end():
    """The JAX package's ``jac`` ``solve`` (1 island, deterministic: one
    compile, then a query each) and the port's on 4 PR2 targets at 8 steps,
    ``counter=True``: q within 1e-4, the same successes, equal
    ``SolveStats`` summaries (but the wall time)."""
    n = 4
    cfg = dict(islands=1, max_steps=8, steps_per_check=8, counter=True)
    jm, tm, js, ts = _pair("pr2_arm.urdf", "jac", **cfg)
    jd, _ = _rows(jm, tm, js, np.random.default_rng(8), n)
    td = tree_from_numpy(jd, "cpu")
    ok = []
    for i in range(n):
        seed = jd["seed_full"][i]
        jr = js.solve(seed, key=jax.random.PRNGKey(i),
                      data=jax.tree.map(lambda x: x[i], jd))
        tr = ts.solve(torch.from_numpy(seed), key=[0, i], data=tree_map(lambda x: x[i], td))
        np.testing.assert_allclose(tr.q.numpy(), np.asarray(jr.q), rtol=0, atol=1e-4)
        assert bool(tr.success) == bool(jr.success)
        ok.append(bool(jr.success))
    assert any(ok)
    js_, ts_ = js.stats.summary(), ts.stats.summary()
    for k in ("queries", "batches", "success_rate", "mean_steps_per_call"):
        assert ts_[k] == js_[k], k
    assert np.isclose(ts_["mean_fitness"], js_["mean_fitness"], rtol=1e-3, atol=1e-9)


# ---------------------------------------------------------------------------
# port-only: the solvers descend


@pytest.mark.parametrize("mode,dtype,steps", [("bio1", "float32", 4),
                                              ("gd_c", "float64", 16),
                                              ("jac", "float32", 4)])
def test_solvers_lower_the_position_error(mode, dtype, steps):
    """On 8 PR2 targets 0.3 rad about the seed, ``solve_batch`` on the island
    path lowers the median position error from the seed's; float64 runs in
    float64 end to end."""
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    B = 8
    b = m._np_bounds
    q = np.clip(m.neutral_q() + np.random.default_rng(4).uniform(-0.3, 0.3, (B, 7)),
                b["min"], b["max"])
    fk = make_fk(m, [TIP])
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
        mode=mode, dtype=dtype, dtwist=1e-3, max_steps=steps, steps_per_check=steps))
    assert s.engine is None and "not a fused bio2 family" in s.unsupported
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(), s.make_data(m.neutral_q()))
    tg = fk(torch.as_tensor(q, dtype=data["seed_full"].dtype))
    data["primary"][0]["position"], data["primary"][0]["orientation"] = tg.pos, tg.quat
    res = s.solve_batch(torch.stack([torch.zeros(B), torch.arange(B)], -1).long(), data)
    assert res.q.dtype == data["seed_full"].dtype
    err = (fk(res.q).pos - tg.pos)[:, 0].norm(dim=-1)
    err0 = (fk(data["seed_full"]).pos - tg.pos)[:, 0].norm(dim=-1)
    assert err.median() < 0.5 * err0.median(), (err, err0)


def test_bio1_devices_tool_on_the_cpu():
    """``tools/bio1_devices`` on the CPU at 4 targets and 2 steps: the FK
    norms' report, a solve per key word, and the lockstep run, whose two
    sides (both the CPU here) stay equal."""
    from bio_ik_tpu_torch.tools import bio1_devices as T

    norms = T.fk_norms("cpu")["cpu"]
    assert abs(norms["norm2_minus_1_mean"]) < 1e-6 and norms["self_angle_max_rad"] < 2e-3
    st = T.stream("cpu", 2, 2, linear=True, n=4)
    assert st["n"] == 8 and len(st["success_by_key_word"]) == 2
    sd = T.shared_draws("cpu", 2, linear=True, n=4)
    assert sd["frac_rows_solution_within_1e-4"] == 1.0
    assert all(d["max_abs_genes_diff"] == 0.0 for d in sd["first_steps"])


# ---------------------------------------------------------------------------
# the JAX anchors of chip_smoke.py's unfused_modes rows


@pytest.mark.slow
@pytest.mark.parametrize("mode,steps,dtype,anchor", [
    ("gd_c_4", 256, "float64", 0.828), ("jac_4", 32, "float32", 0.969)])
def test_unfused_modes_anchor_of_the_jax_package(mode, steps, dtype, anchor):
    """The JAX package on the CPU over Table B's 64 PR2 targets at the
    smoke's budgets (tools/parity_rates.py:89-112: default_rng(42) targets,
    neutral seeds, steps_per_check = max_steps, keys from PRNGKey(7)): its
    success re-measured beside the recorded anchor (BENCHMARKS.md:165,
    :168), within 3 standard errors; printed for PERF.md.  jac_4 takes ~6
    min on a CPU; gd_c_4 in float64 hours (its island path did not finish
    4 steps of 64 queries in 10 min)."""
    n = 64
    with jax.enable_x64(dtype == "float64"):
        jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
        tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
        b = tm._np_bounds
        qg = np.random.default_rng(42).uniform(b["min"], b["max"], (n, 7)).astype(np.float32)
        tg = make_fk(tm, [TIP])(torch.from_numpy(qg))
        s = JIKSolver(jm, [JG.PoseGoal(link=TIP)], JSolverConfig(
            mode=mode, max_steps=steps, dtwist=1e-3, steps_per_check=steps, dtype=dtype))
        d0 = s.make_data(jnp.asarray(jm.neutral_q()))
        data = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
        data["primary"][0]["position"] = jnp.asarray(tg.pos.numpy(), d0["seed_full"].dtype)
        data["primary"][0]["orientation"] = jnp.asarray(tg.quat.numpy(),
                                                        d0["seed_full"].dtype)
        res = s.solve_batch(jax.random.split(jax.random.PRNGKey(7), n), data)
        got = np.asarray(res.success).mean()
    print(f"{mode} {dtype} {steps} steps: success {got:.4f} (recorded {anchor})")
    assert abs(got - anchor) <= 3 * np.sqrt(anchor * (1 - anchor) / n)
