"""The port's linearizer and Jacobian (``kinematics/approx.py``) against the
JAX package (CPU), and the quaternion gene slices of the species tier.

Analytic columns (revolute/prismatic joints) are held to the JAX package's
at float32 FK precision (1e-5).  Forward-difference columns (floating and
planar variables) are ``(FK(q + ε·e_v) − FK(q))/ε`` with ε = 1e-4:

  * evaluated in float64, the port's columns are held to the float64
    derivative of exact FK with the 2e-3 tolerance of the JAX package's
    own finite-difference check (tests/test_floating.py:87-115) — that
    checks the construction free of rounding (measured error: truncation,
    ≤ 9e-5);
  * in float32 each side carries its own FK rounding divided by ε: a few
    ulps of a ~1 m value over 1e-4, measured up to 3.9e-3 from the float64
    derivative over 256 configurations of the floating arm.  The port's
    and the JAX package's float32 columns are held to each other at 5e-3
    (the floating arm's comparison is in the slow tier: the JAX package's
    eager FK of a floating joint takes ~10 s here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.kinematics import (apply_deltas as j_apply_deltas,
                                   apply_deltas_single as j_apply_deltas_single,
                                   make_jacobian as j_make_jacobian,
                                   make_linearizer as j_make_linearizer)

from bio_ik_tpu_torch import RobotModel, make_fk
from bio_ik_tpu_torch.kinematics import (apply_deltas, apply_deltas_single,
                                         make_jacobian, make_linearizer)
from bio_ik_tpu_torch.math.quat import quat_conj, quat_mul, quat_to_rotvec_wrapped
from bio_ik_tpu_torch.solvers.bio2 import quat_gene_slices

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

FD_ROBOTS = ("free_arm.urdf", "planar_arm.urdf")


def _models(name):
    return (JRobotModel.from_urdf_file(asset_path(name)),
            RobotModel.from_urdf_file(asset_path(name), device="cpu"))


def _configs(tm, rng, n):
    """Uniform draws in the bounds; floating quaternion blocks normalized
    (the solver keeps them near unit norm)."""
    b = tm._np_bounds
    q = rng.uniform(b["min"], b["max"], size=(n, tm.nvars))
    for s in quat_gene_slices(tm, range(tm.nvars)):
        q[:, s:s + 4] /= np.linalg.norm(q[:, s:s + 4], axis=1, keepdims=True)
    return q.astype(np.float32)


def test_linearizer_analytic_columns_match_jax(rng):
    jm, tm = _models("pr2_arm.urdf")
    tip = ["r_gripper_tool_frame"]
    q = _configs(tm, rng, 32)
    jt, jd = j_make_linearizer(jm, tip, list(range(7)))(jnp.asarray(q))
    tt, td = make_linearizer(tm, tip, list(range(7)))(torch.from_numpy(q))
    assert td.shape == (32, 1, 7, 7)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def _reference_columns(tm, q, tip, h=1e-6):
    """float64 central differences of exact FK: ∂(pos, quat)/∂q_v and the
    world angular velocity (rotation vector of q(x+h)·q(x−h)⁻¹ over 2h)."""
    fk = make_fk(tm, [tip])
    q64 = torch.from_numpy(q.astype(np.float64))
    lin, jac = [], []
    for v in range(tm.nvars):
        e = torch.zeros(tm.nvars, dtype=torch.float64)
        e[v] = h
        tp, tn = fk(q64 + e), fk(q64 - e)
        lin.append(torch.cat([tp.pos - tn.pos, tp.quat - tn.quat], -1)[:, 0] / (2 * h))
        rot = quat_to_rotvec_wrapped(quat_mul(tp.quat, quat_conj(tn.quat)))
        jac.append(torch.cat([tp.pos - tn.pos, rot], -1)[:, 0] / (2 * h))
    return torch.stack(lin, 1).numpy(), torch.stack(jac, -1).numpy()


@pytest.mark.parametrize("name", FD_ROBOTS)
def test_fd_columns_match_derivative(name, rng):
    """The forward-difference construction, free of rounding: in float64
    the columns are the derivative up to truncation."""
    tm = _models(name)[1]
    V = tm.nvars
    q = _configs(tm, rng, 16)
    ref_lin, ref_jac = _reference_columns(tm, q, "tool")   # (16, V, 7), (16, 6, V)
    q64 = torch.from_numpy(q.astype(np.float64))
    _, deltas = make_linearizer(tm, ["tool"], list(range(V)))(q64)
    _, J = make_jacobian(tm, ["tool"], list(range(V)))(q64)
    # the base's (floating/planar) columns are non-zero
    assert np.abs(deltas.numpy()[:, 0, 0:3]).max() > 0.1
    np.testing.assert_allclose(deltas.numpy()[:, 0], ref_lin, atol=2e-3)
    np.testing.assert_allclose(J.numpy()[:, 0], ref_jac, atol=2e-3)


@pytest.mark.parametrize("name", [
    "planar_arm.urdf",
    # the JAX package's floating-base FK runs for ~10 s eagerly here
    pytest.param("free_arm.urdf", marks=pytest.mark.slow),
])
def test_fd_columns_match_jax(name, rng):
    jm, tm = _models(name)
    V = tm.nvars
    q = _configs(tm, rng, 16)
    _, td = make_linearizer(tm, ["tool"], list(range(V)))(torch.from_numpy(q))
    tf, tj = make_jacobian(tm, ["tool"], list(range(V)))(torch.from_numpy(q))
    j_lin = j_make_linearizer(jm, ["tool"], list(range(V)))
    j_jac = j_make_jacobian(jm, ["tool"], list(range(V)))
    # one compile for both (cheaper here than their eager op-by-op runs)
    (_, jd), (jf, jj) = jax.jit(lambda x: (j_lin(x), j_jac(x)))(jnp.asarray(q))
    jd, jj = np.asarray(jd), np.asarray(jj)
    np.testing.assert_allclose(td.numpy(), jd, atol=5e-3)
    np.testing.assert_allclose(tj.numpy(), jj, atol=5e-3)
    # the revolute joints' analytic columns at float32 FK precision
    rev = [v for v in range(V) if tm.var_is_revolute[v]]
    assert rev
    np.testing.assert_allclose(td.numpy()[:, :, rev], jd[:, :, rev], atol=1e-5)
    np.testing.assert_allclose(tj.numpy()[..., rev], jj[..., rev], atol=1e-5)
    np.testing.assert_allclose(tf.pos.numpy(), np.asarray(jf.pos), atol=1e-5)


def test_apply_deltas_match_jax(rng):
    tips0 = rng.normal(size=(3, 2, 7)).astype(np.float32)
    deltas = rng.normal(size=(3, 2, 5, 7)).astype(np.float32)
    dq = rng.normal(size=(3, 4, 5)).astype(np.float32)
    out = apply_deltas(*map(torch.from_numpy, (tips0, deltas, dq)))
    ref = j_apply_deltas(*map(jnp.asarray, (tips0, deltas, dq)))
    assert out.shape == (3, 4, 2, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    phen = out[:, 0]
    one = apply_deltas_single(phen, torch.from_numpy(deltas), 2, 0.5)
    ref1 = j_apply_deltas_single(jnp.asarray(phen.numpy()), jnp.asarray(deltas), 2, 0.5)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref1), rtol=1e-6, atol=1e-6)


def test_quat_gene_slices():
    """The rule of the JAX package's Bio2Solver (solvers/bio2.py:69-81):
    free_arm's quaternion block starts at gene 3 (its test_floating.py
    asserts the block is found)."""
    tm = _models("free_arm.urdf")[1]
    assert quat_gene_slices(tm, range(10)) == [3]
    # the block counts only when its four variables are active and contiguous
    assert quat_gene_slices(tm, [0, 1, 2, 3, 4, 5, 7, 8, 9]) == []
    assert quat_gene_slices(tm, [3, 4, 5, 6, 0]) == [0]
    for name in ("planar_arm.urdf", "pr2_arm.urdf"):
        m = RobotModel.from_urdf_file(asset_path(name), device="cpu")
        assert quat_gene_slices(m, range(m.nvars)) == []


def test_solver_context_has_linearizer_and_jacobian(rng):
    from bio_ik_tpu_torch import IKSolver
    import bio_ik_tpu_torch.goals as G

    _, tm = _models("planar_arm.urdf")
    ctx = IKSolver(tm, [G.PositionGoal(link="tool")]).ctx
    q = torch.from_numpy(_configs(tm, rng, 4))
    tips0, deltas = ctx.linearize(q)
    assert tips0.shape == (4, 1, 7) and deltas.shape == (4, 1, 5, 7)
    ref_t, ref_d = make_linearizer(tm, ["tool"], list(range(5)))(q)
    assert torch.equal(tips0, ref_t) and torch.equal(deltas, ref_d)
    _, J = ctx.jacobian(q)
    assert J.shape == (4, 1, 6, 5)
