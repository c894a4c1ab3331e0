"""The port's ``optlib_*`` family and its batched L-BFGS against the JAX
package and optax (CPU).

Each variant's ``step`` runs on 6 rows of the 3-joint arm (numpy-made
targets and configurations, carried across with ``interop``), both sides
in float64, for 4 steps (16 inner updates): the configuration, the best
configuration and its fitness within 1e-8, and the restart flags (where
the step's fitness and the best before it differ by more than 1e-15).  The
``_r`` variants start with every other row flagged stuck and are fed the
uniforms JAX draws for the restart (optlib.py:201-204).  The default tier
compiles one JAX program (``lbfgs``); the other variants are ``slow``.

Also: the clip the objectives differentiate through has ``jnp.clip``'s
gradient at, inside and outside the bounds; and (``slow``) the JAX
package's own anchors (tests/test_solvers.py:203, :306) applied to the
port on the PR2 arm, and the JAX package's success on the first 16 of
Table B's targets, which ``chip_smoke.py`` holds the card to
(``JAX_OTHER_SUCCESS``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch.interop import tree_from_numpy
from tests.test_torch_solvers import ARM3, TIP, _keys, _pair, _rows

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

N_ROWS, N_STEPS = 6, 4


def _steps_of_both(variant, rng):
    """``N_STEPS`` steps of ``optlib_<variant>`` on ``N_ROWS`` rows on both
    sides in float64 (one jitted JAX program); → (JAX state, port state,
    the rows' start)."""
    n, reset = N_ROWS, variant.endswith("_r")
    with jax.enable_x64(True):
        jm, tm, js, ts = _pair("arm3", f"optlib_{variant}", dtype="float64")
        jd, q = _rows(jm, tm, js, rng, n)
        jd["seed_full"], jd["seed_active"] = q, q
        stuck = jnp.asarray((np.arange(n) % 2 == 0) & reset)

        def run(k, d, s):
            st = js.solver.init(k, d, False)._replace(stuck=s)

            def body(st, _):
                k1 = jax.random.split(st.key)[1]
                return js.solver.step(st, d), jax.random.uniform(k1, (3,), jnp.float64)

            return jax.lax.scan(body, st, None, length=N_STEPS)

        jst, us = jax.jit(jax.vmap(run))(_keys(rng, n), jd, stuck)
        jst, us = jax.tree.map(np.asarray, jst), np.asarray(us)
    td = tree_from_numpy(jd, "cpu")
    st = ts.solver.init(torch.Generator(), td, torch.zeros(n, dtype=torch.bool))
    st = st._replace(stuck=torch.from_numpy(np.asarray(stuck)))
    for i in range(N_STEPS):
        prev = st
        st = ts.solver.step(st, td, rand_u=torch.from_numpy(us[:, i]))
    # the last step's fitness against the best before it: the restart flag
    # compares the two, which at convergence can tie to rounding
    gap = ts.solver._objective(td)(st.qa) - prev.best_fitness
    return jst, st, q, gap.numpy()


def _assert_steps_match(variant, rng):
    jst, st, q, gap = _steps_of_both(variant, rng)
    assert isinstance(st.opt_state, tuple) and st.qa.dtype == torch.float64
    assert np.abs(jst.best - q).max() > 1e-3          # the steps moved
    for name in ("qa", "best", "best_fitness"):
        np.testing.assert_allclose(getattr(st, name).numpy(), getattr(jst, name),
                                   rtol=0, atol=1e-8, err_msg=name)
    if not variant.endswith("_r"):
        assert not st.stuck.any() and not jst.stuck.any()
        return
    # equal restart flags, except where the last step's fitness and the best
    # before it agree within 1e-15 (rounding decides ``<`` there)
    decided = np.abs(gap) > 1e-15
    assert decided.sum() >= 2
    np.testing.assert_array_equal(st.stuck.numpy()[decided], jst.stuck[decided])


def test_lbfgs_steps_match_jax(rng):
    """4 steps of ``optlib_lbfgs`` (the batched L-BFGS with the zoom line
    search) equal the JAX package's over optax within 1e-8 in float64."""
    _assert_steps_match("lbfgs", rng)


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["bfgs", "lbfgsb", "gd", "cgd", "nd", "nm",
                                     "lbfgs_r", "gd_r", "nm_r"])
def test_variant_steps_match_jax(variant, rng):
    """4 steps of each other variant equal the JAX package's within 1e-8 in
    float64; the ``_r`` ones with JAX's restart uniforms.  ``slow``: one
    JAX compile of 4–14 s each."""
    _assert_steps_match(variant, rng)


def test_clip_tied_gradient_matches_jnp_clip():
    """The objectives' clip has ``jnp.clip``'s gradient: 1 inside, ½ at a
    bound, 0 outside (``torch.clamp`` passes all of it at a bound), and
    :meth:`SolverContext.clip`'s values."""
    m = RobotModel.from_urdf_string(ARM3, device="cpu")
    s = IKSolver(m, [G.PoseGoal(link="tool")], SolverConfig(mode="optlib_lbfgs"))
    lo, hi = s.problem.aclip_min.numpy(), s.problem.aclip_max.numpy()
    x = np.stack([lo, hi, 0.5 * (lo + hi), lo - 0.5, hi + 0.5]).astype(np.float32)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi) ** 2))(x))
    np.testing.assert_array_equal(jg[[0, 1, 3, 4]], np.stack([lo, hi, 0 * lo, 0 * hi]))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad((s.ctx.clip_tied(xt) ** 2).sum(), xt)
    np.testing.assert_array_equal(tg.numpy(), jg)
    np.testing.assert_array_equal(s.ctx.clip_tied(xt).detach().numpy(),
                                  s.ctx.clip(xt).detach().numpy())
    (cg,) = torch.autograd.grad((s.ctx.clip(xt) ** 2).sum(), xt)
    np.testing.assert_array_equal(cg[0].numpy(), 2 * lo)   # torch.clamp at a bound


# ---------------------------------------------------------------------------
# the JAX package's anchors (tests/test_solvers.py), applied to the port


def _pr2():
    return RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")


def _targets(m, rng, n):
    b = m._np_bounds
    qg = rng.uniform(b["min"], b["max"], (n, m.nvars)).astype(np.float32)
    return make_fk(m, [TIP])(torch.from_numpy(qg))


def _solve_errs(m, cfg, tg, seed=None):
    """``IKSolver.solve`` of each target from the neutral seed (key (0, i),
    as tests/test_solvers.py:47-58): position errors, seed errors,
    solutions."""
    s = IKSolver(m, [G.PoseGoal(link=TIP)], cfg)
    fk = make_fk(m, [TIP])
    q0 = torch.as_tensor(m.neutral_q())
    errs, err0, qs = [], [], []
    for i in range(tg.pos.shape[0]):
        d = s.make_data(q0)
        d["primary"][0]["position"] = tg.pos[i]
        d["primary"][0]["orientation"] = tg.quat[i]
        r = s.solve(q0, key=[0, i], data=d)
        errs.append(float((fk(r.q).pos[0] - tg.pos[i, 0]).norm()))
        err0.append(float((fk(q0).pos[0] - tg.pos[i, 0]).norm()))
        qs.append(r.q)
    return np.array(errs), np.array(err0), torch.stack(qs), s


@pytest.mark.slow
def test_lbfgs_4_solves_like_the_jax_anchor(rng):
    """tests/test_solvers.py:203 on the port: ``optlib_lbfgs_4``, 16 steps,
    median position error of 2 targets < 2e-2."""
    m = _pr2()
    errs, _, _, _ = _solve_errs(m, SolverConfig(mode="optlib_lbfgs_4", max_steps=16,
                                                dtwist=1e-3), _targets(m, rng, 2))
    assert np.median(errs) < 2e-2, errs


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["lbfgsb", "cgd", "nd", "nm"])
def test_derivative_variants_reduce_error(variant, rng):
    """tests/test_solvers.py:306 on the port: 12 steps bring the error below
    max(½ the seed's, 2e-2); ``lbfgsb``'s solution inside the box."""
    m = _pr2()
    errs, err0, qs, s = _solve_errs(m, SolverConfig(mode=f"optlib_{variant}",
                                                    max_steps=12, dtwist=1e-3),
                                    _targets(m, rng, 1))
    assert errs[0] < max(0.5 * err0[0], 2e-2), (variant, err0, errs)
    if variant == "lbfgsb":
        qa = qs[:, s.ctx.av]
        assert bool((qa >= s.problem.aclip_min - 1e-6).all()
                    and (qa <= s.problem.aclip_max + 1e-6).all())


# ---------------------------------------------------------------------------
# the JAX package on Table B's targets: chip_smoke.py's anchors

TABLE_B_FIRST = 16


@pytest.mark.slow
@pytest.mark.parametrize("mode,steps", [("optlib_lbfgs_4", 16), ("bio2_memetic_lbfgs", 16)])
def test_table_b_success_of_the_jax_package(mode, steps, capsys):
    """The JAX package's island path (``solve_batch``, plain jnp on the CPU)
    on the first 16 of Table B's 64 PR2 targets (``default_rng(42)``
    uniform in the bounds, a PoseGoal at 1 mm, neutral seeds, keys (7, i),
    ``steps_per_check = max_steps``): its success equals chip_smoke.py's
    ``JAX_OTHER_SUCCESS``; the port's on the same targets is printed beside
    it (run with ``-s``)."""
    import bio_ik_tpu.goals as JG
    from bio_ik_tpu import RobotModel as JRobotModel
    from bio_ik_tpu.api import IKSolver as JIKSolver
    from bio_ik_tpu.config import SolverConfig as JSolverConfig
    from bio_ik_tpu.kinematics import make_fk as j_make_fk
    from tests.test_torch_instances import _chip_smoke

    n = TABLE_B_FIRST
    cfg = dict(mode=mode, dtwist=1e-3, max_steps=steps, steps_per_check=steps)
    jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    js = JIKSolver(jm, [JG.PoseGoal(link=TIP)], JSolverConfig(fused="off", **cfg))
    b = jm._np_bounds
    qg = np.random.default_rng(42).uniform(b["min"], b["max"], (64, jm.nvars))
    qg = qg.astype(np.float32)[:n]
    jt = j_make_fk(jm, [TIP])(jnp.asarray(qg))
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                      js.make_data(jnp.asarray(jm.neutral_q())))
    jd["primary"][0]["position"], jd["primary"][0]["orientation"] = jt.pos, jt.quat
    keys = jnp.stack([jnp.full(n, 7, jnp.uint32), jnp.arange(n, dtype=jnp.uint32)], -1)
    jax_success = float(np.mean(np.asarray(js.solve_batch(keys, jd).success)))

    m = _pr2()
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(**cfg))
    tg = make_fk(m, [TIP])(torch.from_numpy(qg))
    d = tree_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
    d["primary"][0]["position"], d["primary"][0]["orientation"] = tg.pos, tg.quat
    res = s.solve_batch(torch.stack([torch.full((n,), 7), torch.arange(n)], -1), d)
    with capsys.disabled():
        print(f"\n{mode}: JAX success {jax_success} port {float(res.success.float().mean())}")
    assert jax_success == _chip_smoke().JAX_OTHER_SUCCESS[mode]
