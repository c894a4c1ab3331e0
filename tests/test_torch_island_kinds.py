"""The four goal kinds only the island path evaluates — touch, balance,
link_function and joint_function — against the JAX package (CPU).

Each kind's fitness (primary, and joint_function's as a secondary goal)
and the acceptance test are held to the JAX package's on the same tip
frames and configurations, 16 of them made with numpy from a seed: within
1e-5 relative.  touch runs on the gripper's fingertip mesh
(``assets/pr2_gripper_tip.stl``) and on the automatic surface of the tool
frame's box; balance on the PR2 arm's inertials, whose every massive link
becomes a tip after the goals' own.  The function goals are written once
in jnp and once in torch.  The autograd gradients of the four kinds are
held to ``jax.grad`` in ``test_torch_bio2_unfused.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bio_ik_tpu.goals as JG
from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.math.frame import Frame as JFrame
from bio_ik_tpu.problem import Problem as JProblem

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.math.frame import Frame
from bio_ik_tpu_torch.problem import Problem

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
WRIST = "r_wrist_roll_link"   # its collision geometry is the fingertip mesh
N = 16


def link_fn(M):
    """A link function in the goals module's own tensor library."""
    if M is JG:
        return lambda p, q: jnp.sum(jnp.square(p - jnp.asarray([0.6, -0.2, 0.7])),
                                    axis=-1) + 0.1 * q[..., 2] ** 2
    return lambda p, q: torch.sum(torch.square(p - p.new_tensor([0.6, -0.2, 0.7])),
                                  dim=-1) + 0.1 * q[..., 2] ** 2


def joint_fn(M):
    """Preferred values of (shoulder pan, elbow flex): halfway to 0.3."""
    return lambda v: 0.5 * (v + 0.3)


KINDS = {
    "touch_mesh": lambda M: [M.TouchGoal(link=WRIST, position=(0.0, 0.0, 0.6),
                                         normal=(0.2, 0.1, 1.0))],
    "touch_auto": lambda M: [M.TouchGoal(link=TIP, position=(0.5, -0.2, 0.7),
                                         normal=(0.0, 0.0, 1.0), weight=2.0)],
    "balance": lambda M: [M.PoseGoal(link=TIP),
                          M.BalanceGoal(target=(0.2, -0.1, 0.0), axis=(0.0, 0.1, 1.0),
                                        weight=0.7)],
    "link_function": lambda M: [M.LinkFunctionGoal(link=TIP, function=link_fn(M))],
    "joint_function": lambda M: [
        M.PositionGoal(link=TIP, position=(0.6, -0.2, 0.7)),
        M.JointFunctionGoal(variable_names=("r_shoulder_pan_joint", "r_elbow_flex_joint"),
                            function=joint_fn(M), weight=0.5),
        M.JointFunctionGoal(variable_names=("r_forearm_roll_joint",), function=joint_fn(M),
                            weight=0.3, secondary=True)],
}


@pytest.fixture(scope="module")
def arms():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


@pytest.mark.parametrize("case", sorted(KINDS))
def test_island_kinds_match_jax(case, arms, rng):
    """The compiled groups (kinds, tips, static arrays), the primary and
    secondary fitness within 1e-5 relative and the acceptance test of
    each kind at 16 configurations: the same tip frames and
    configurations on both sides."""
    jm, tm = arms
    cfg = SolverConfig(dtwist=1e-3)
    jp = JProblem(jm, KINDS[case](JG), config=cfg)
    tp = Problem(tm, KINDS[case](G), config=cfg)
    assert tp.tip_links == jp.tip_links
    assert [(g.kind, g.goal_type) for g in tp.primary] == [
        (g.kind, g.goal_type) for g in jp.primary]
    assert [g.kind for g in tp.secondary] == [g.kind for g in jp.secondary]
    for tg, jg in zip(tp.primary + tp.secondary, jp.primary + jp.secondary):
        np.testing.assert_array_equal(tg.tip_slots, jg.tip_slots)
        for k, v in jg.static.items():
            if k != "function":
                np.testing.assert_array_equal(tg.static[k], v, err_msg=k)
    b = tm._np_bounds
    q = rng.uniform(b["min"], b["max"], (N, tm.nvars)).astype(np.float32)
    tips = make_fk(tm, tp.tip_links)(torch.from_numpy(q))
    packed = torch.cat([tips.pos, tips.quat], -1)
    jd = jp.make_data(jnp.asarray(jm.neutral_q()))
    td = tp.make_data(torch.as_tensor(tm.neutral_q()))
    jpk = jnp.asarray(packed.numpy())
    jf = np.asarray(jp.fitness(jpk, jnp.asarray(q), jd))
    tf = tp.fitness(packed, torch.from_numpy(q), td).numpy()
    assert np.ptp(jf) > 1e-3 * np.abs(jf).max()
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tp.fitness_secondary(torch.from_numpy(q), td).numpy(),
                               np.asarray(jp.fitness_secondary(jnp.asarray(q), jd)),
                               rtol=1e-5, atol=1e-7)
    jok = np.asarray(jp.check_solution(JFrame(jnp.asarray(tips.pos.numpy()),
                                              jnp.asarray(tips.quat.numpy())),
                                       jnp.asarray(q), jd))
    tok = tp.check_solution(Frame(tips.pos, tips.quat), torch.from_numpy(q), td).numpy()
    np.testing.assert_array_equal(tok, jok)


def test_island_kinds_solve_on_the_island_path(arms):
    """A PoseGoal beside each kind builds an IKSolver whose solve_batch
    takes the island path (the fused kernels do not evaluate these kinds)
    and returns finite configurations that lower the combined fitness."""
    tm = arms[1]
    goals = [G.PoseGoal(link=TIP)] + [g for k in sorted(KINDS) for g in KINDS[k](G)
                                      if not isinstance(g, G.PoseGoal)]
    s = IKSolver(tm, goals, SolverConfig(dtwist=1e-3, max_steps=2, islands=1))
    assert s.engine is None and "not in the fused" in s.unsupported
    B = 2
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                    s.make_data(torch.as_tensor(tm.neutral_q())))
    res = s.solve_batch(torch.tensor([[0, 1], [0, 2]]), data)
    assert torch.isfinite(res.q).all()
    f0 = s.ctx.fitness_combined_exact(data["seed_active"], data)
    assert (s.ctx.fitness_combined_exact(res.qa, data) <= f0).all()


def test_balance_needs_inertials():
    """A robot without inertials (the planar arm) rejects a BalanceGoal, as
    in the JAX package."""
    m = RobotModel.from_urdf_file(asset_path("planar_arm.urdf"), device="cpu")
    assert not m.masses.any()
    with pytest.raises(ValueError, match="inertial mass"):
        Problem(m, [G.BalanceGoal()])
