"""The port's ``neural`` and ``neural2`` modes against the JAX package and
optax (CPU).

  * Adam: 5 steps of :func:`solvers.neural.train` from weights carried
    across (``interop.mlp_params_from_jax``) on the same batches equal
    ``optax.adam(1e-3)``'s within 1e-10 in float64;
  * a step of each mode on 6 rows of the 3-joint arm, from the JAX
    package's trained weights carried across, equals the JAX package's
    within 1e-8 in float64 (the JAX side trains 2 steps: its jitted
    training loop is the file's two JAX compiles; the steps run eagerly);
  * the network's shape and initialization, training lowering the loss,
    and the pose-type-goal requirement;
  * (``slow``) the JAX package's anchors on the PR2 arm applied to the port
    (tests/test_solvers.py:338, :357).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu.solvers.neural import _mlp_apply
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path, make_fk
from bio_ik_tpu_torch.interop import mlp_params_from_jax, tree_from_numpy
from bio_ik_tpu_torch.solvers.neural import MLP, train
from tests.test_torch_solvers import ARM3, TIP, _keys, _pair, _rows

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)


def test_adam_steps_match_optax(rng):
    """5 Adam steps on the same batches from the same weights: the port's
    ``torch.optim.Adam`` loop equals optax's within 1e-10 (float64), and
    the losses it reports."""
    sizes, n = (9, 50, 50, 3), 32
    batches = [(rng.normal(size=(n, sizes[0])), rng.normal(size=(n, sizes[-1])))
               for _ in range(5)]
    params = [(rng.normal(size=(a, b)) * np.sqrt(2.0 / a), np.zeros(b))
              for a, b in zip(sizes[:-1], sizes[1:])]
    net = mlp_params_from_jax(params, "cpu")
    with jax.enable_x64(True):
        params = jax.tree.map(jnp.asarray, params)
        opt = optax.adam(1e-3)
        state = opt.init(params)
        losses = []
        for X, Y in batches:
            loss, g = jax.value_and_grad(
                lambda p: jnp.mean(jnp.square(_mlp_apply(p, X) - Y)))(params)
            upd, state = opt.update(g, state)
            params = optax.apply_updates(params, upd)
            losses.append(float(loss))
    last = train(net, lambda i: tuple(torch.from_numpy(a) for a in batches[i]),
                 lambda X, Y: (X, Y), 5)
    assert net.layers[0].weight.dtype == torch.float64
    np.testing.assert_allclose(float(last), losses[-1], rtol=1e-12)
    for lin, (w, b) in zip(net.layers, params):
        np.testing.assert_allclose(lin.weight.detach().numpy().T, np.asarray(w),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["neural", "neural2"])
def test_step_from_carried_weights_matches_jax(mode, rng):
    """One step of each mode on 6 rows from the JAX package's trained
    weights: configuration, best and best fitness within 1e-8 (float64)."""
    n = 6
    with jax.enable_x64(True):
        jm, tm, js, ts = _pair("arm3", mode, dtype="float64", neural_train_steps=2)
        jd, q = _rows(jm, tm, js, rng, n, spread=0.3)
        jd["seed_full"], jd["seed_active"] = q, q
        jst = jax.vmap(lambda k, d: js.solver.step(js.solver.init(k, d, False), d))(
            _keys(rng, n), jd)
        jst = jax.tree.map(np.asarray, jst)
    ts.solver.net = mlp_params_from_jax(jax.tree.map(np.asarray, js.solver.params), "cpu")
    td = tree_from_numpy(jd, "cpu")
    st = ts.solver.init(torch.Generator(), td, torch.zeros(n, dtype=torch.bool))
    st = ts.solver.step(st, td)
    assert np.abs(jst.qa - q).max() > 1e-3
    for name in ("qa", "best", "best_fitness"):
        np.testing.assert_allclose(getattr(st, name).numpy(), getattr(jst, name),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_network_training_and_goal_check():
    """``neural``'s network is (6T + V, 50, V) and ``neural2``'s (7T, 50, 50,
    V), with zero biases and weights of variance 2/d_in; 150 training steps
    lower the loss of a held batch; the same seed trains the same weights;
    a problem without a pose-type goal raises as in the JAX package."""
    m = RobotModel.from_urdf_string(ARM3, device="cpu")
    goals = [G.PoseGoal(link="tool")]
    sizes = {"neural": [(9, 50), (50, 3)], "neural2": [(7, 50), (50, 50), (50, 3)]}
    for mode in ("neural", "neural2"):
        s0 = IKSolver(m, goals, SolverConfig(mode=mode, neural_train_steps=0))
        net0 = s0.solver.net
        assert [(lin.in_features, lin.out_features) for lin in net0.layers] == sizes[mode]
        assert all(not lin.bias.detach().any() for lin in net0.layers)
        w = net0.layers[0].weight.detach()
        assert abs(float(w.var()) * w.shape[1] / 2 - 1) < 0.5
        g = torch.Generator().manual_seed(11)
        X, Y = s0.solver._make_batch(g)
        s1 = IKSolver(m, goals, SolverConfig(mode=mode, neural_train_steps=150))
        with torch.no_grad():
            l0 = float(torch.mean((net0(X) - Y) ** 2))
            l1 = float(torch.mean((s1.solver.net(X) - Y) ** 2))
        assert l1 < 0.8 * l0 and torch.isfinite(s1.solver.final_loss)
        a, b = (IKSolver(m, goals, SolverConfig(mode=mode, neural_train_steps=5))
                for _ in range(2))
        assert torch.equal(a.solver.net.layers[0].weight, b.solver.net.layers[0].weight)
    with pytest.raises(ValueError, match="pose-type goals"):
        IKSolver(m, [G.LookAtGoal(link="tool", axis=(1.0, 0.0, 0.0),
                                  target=(1.0, 0.0, 0.5))],
                 SolverConfig(mode="neural", neural_train_steps=0))
    assert isinstance(s1.solver.net, MLP)


# ---------------------------------------------------------------------------
# the JAX package's anchors (tests/test_solvers.py), applied to the port


def _solve_one(mode, steps, train_steps, rng):
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(
        mode=mode, max_steps=steps, dtwist=1e-3, neural_train_steps=train_steps))
    b = m._np_bounds
    fk = make_fk(m, [TIP])
    tg = fk(torch.as_tensor(rng.uniform(b["min"], b["max"], (1, m.nvars)),
                            dtype=torch.float32))
    q0 = torch.as_tensor(m.neutral_q())
    d = s.make_data(q0)
    d["primary"][0]["position"], d["primary"][0]["orientation"] = tg.pos[0], tg.quat[0]
    res = s.solve(q0, key=[0, 0], data=d)
    return (float((fk(res.q).pos[0] - tg.pos[0, 0]).norm()),
            float((fk(q0).pos[0] - tg.pos[0, 0]).norm()))


@pytest.mark.slow
def test_neural_reduces_error(rng):
    """tests/test_solvers.py:338 on the port: 400 training steps, 16 steps
    bring the position error below the seed's."""
    err, err0 = _solve_one("neural", 16, 400, rng)
    assert err < err0, (err, err0)


@pytest.mark.slow
def test_neural2_regresses_pose(rng):
    """tests/test_solvers.py:357 on the port: 600 training steps, 2 steps,
    position error < 0.5 m."""
    err, _ = _solve_one("neural2", 2, 600, rng)
    assert err < 0.5, err
