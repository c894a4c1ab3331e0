"""The port's core modules against the JAX package (CPU).

Quaternion/frame algebra, the robot model, batched FK, the pose-family
fitness and acceptance test, the per-scenario salt and ``_rewrap`` of
``bio_ik_tpu_torch`` are held to their ``bio_ik_tpu`` counterparts on the
same inputs, made with numpy from a seed and handed to both sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bio_ik_tpu.goals as JG
import bio_ik_tpu.math as jmath
from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.api import IKSolver as JIKSolver
from bio_ik_tpu.config import SolverConfig as JSolverConfig
from bio_ik_tpu.engine import _scenario_salt as j_scenario_salt
from bio_ik_tpu.kinematics import make_fk as j_make_fk
from bio_ik_tpu.problem import Problem as JProblem

import bio_ik_tpu_torch.goals as G
import bio_ik_tpu_torch.math as tmath
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.engine import _scenario_salt
from bio_ik_tpu_torch.problem import Problem

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

ASSETS = ["free_arm.urdf", "humanoid.urdf", "kuka_iiwa.urdf", "planar_arm.urdf",
          "pr2_arm.urdf", "pr2_dual.urdf", "snake.urdf", "ur5.urdf"]
TIP = "r_gripper_tool_frame"
N = 256


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _both(fn_name, *arrays):
    jout = getattr(jmath, fn_name)(*[jnp.asarray(a) for a in arrays])
    tout = getattr(tmath, fn_name)(*[torch.from_numpy(a) for a in arrays])
    return np.asarray(jout), tout.numpy()


# float32 on unit quaternions and O(1) vectors: 1e-6 is a few ulps
@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_conj",
                                  "quat_to_rotvec_wrapped",
                                  "quat_angle_shortest",
                                  "quat_dist_sq_double_cover",
                                  "quat_from_axis_angle", "quat_normalize_fast"])
def test_quat_ops_match_jax(name, rng):
    qa, qb = _quats(rng), _quats(rng)
    vec = rng.normal(size=(N, 3)).astype(np.float32)
    args = {
        "quat_mul": (qa, qb), "quat_rotate": (qa, vec), "quat_conj": (qa,),
        "quat_to_rotvec_wrapped": (qa,), "quat_angle_shortest": (qa, qb),
        "quat_dist_sq_double_cover": (qa, qb),
        "quat_from_axis_angle": (
            vec / np.linalg.norm(vec, axis=-1, keepdims=True),
            rng.uniform(-3, 3, N).astype(np.float32)),
        "quat_normalize_fast": (qa * 1.001,),
    }[name]
    j, t = _both(name, *args)
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize("name", ["frame_mul", "frame_inv", "frame_twist",
                                  "frame_change"])
def test_frame_ops_match_jax(name, rng):
    def frames():
        p = rng.normal(size=(N, 3)).astype(np.float32)
        q = _quats(rng)
        return (jmath.Frame(jnp.asarray(p), jnp.asarray(q)),
                tmath.Frame(torch.from_numpy(p), torch.from_numpy(q)))

    fs = [frames() for _ in range({"frame_inv": 1, "frame_change": 3}.get(name, 2))]
    j = getattr(jmath, name)(*[f[0] for f in fs])
    t = getattr(tmath, name)(*[f[1] for f in fs])
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    t if isinstance(t, tuple) else (t,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


@pytest.mark.parametrize("asset", ASSETS)
def test_robot_model_matches_jax(asset):
    j = JRobotModel.from_urdf_file(asset_path(asset))
    t = RobotModel.from_urdf_file(asset_path(asset), device="cpu")
    assert t.link_names == j.link_names and t.var_names == j.var_names
    assert t.joint_names == j.joint_names and t.mimic_vars == j.mimic_vars
    for f in ("parent", "jtype", "origin_pos", "origin_quat", "axis", "vstart",
              "vcount", "masses", "coms", "mimic_src", "mimic_factor",
              "mimic_offset", "var_is_revolute", "var_is_prismatic"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for k, v in j._np_bounds.items():
        np.testing.assert_array_equal(t._np_bounds[k], v, err_msg=k)
        np.testing.assert_array_equal(getattr(t.bounds, k).numpy(),
                                      np.asarray(getattr(j.bounds, k)))
    np.testing.assert_array_equal(t.neutral_q(), j.neutral_q())
    tips = [t.link_index[t.link_names[-1]]]
    assert t.link_schedule(tips) == j.link_schedule(tips)


@pytest.mark.parametrize("asset,tip", [("pr2_arm.urdf", TIP),
                                       ("snake.urdf", "head")])
def test_make_fk_matches_jax(asset, tip, rng):
    j = JRobotModel.from_urdf_file(asset_path(asset))
    t = RobotModel.from_urdf_file(asset_path(asset), device="cpu")
    b = t._np_bounds
    q = rng.uniform(b["min"], b["max"], size=(64, t.nvars)).astype(np.float32)
    jf = j_make_fk(j, [tip])(jnp.asarray(q))
    tf = make_fk(t, [tip])(torch.from_numpy(q))
    # float32 over chains of ~1 m (snake: 33 links) — a few ulps per link
    np.testing.assert_allclose(tf.pos.numpy(), np.asarray(jf.pos), atol=1e-5)
    np.testing.assert_allclose(tf.quat.numpy(), np.asarray(jf.quat), atol=1e-5)


def test_make_fk_rejects_tensor_on_other_device():
    t = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    fk = make_fk(t, [TIP], device="meta")
    with pytest.raises(ValueError):
        fk(torch.zeros(1, 7))


def _goal(kind, pos, quat):
    if kind == "position":
        return JG.PositionGoal(link=TIP, position=pos), G.PositionGoal(link=TIP, position=pos)
    if kind == "orientation":
        return (JG.OrientationGoal(link=TIP, orientation=quat),
                G.OrientationGoal(link=TIP, orientation=quat))
    return (JG.PoseGoal(link=TIP, position=pos, orientation=quat),
            G.PoseGoal(link=TIP, position=pos, orientation=quat))


@pytest.mark.parametrize("kind", ["position", "orientation", "pose"])
def test_fitness_and_check_solution_match_jax(kind, rng):
    j_m = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    t_m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    b = t_m._np_bounds
    q = rng.uniform(b["min"], b["max"], size=(512, 7)).astype(np.float32)
    tips = make_fk(t_m, [TIP])(torch.from_numpy(q))
    # goals at the tips moved by ~the tolerance, so flags split both ways
    gpos = tips.pos[:, 0].numpy() + rng.normal(size=(512, 3)).astype(np.float32) * 6e-4
    gq = tips.quat[:, 0].numpy() + rng.normal(size=(512, 4)).astype(np.float32) * 3e-4
    gq /= np.linalg.norm(gq, axis=-1, keepdims=True)
    jgoal, tgoal = _goal(kind, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))
    # the JAX acceptance test raises KeyError for orientation goals under a
    # finite dtwist (problem.py:280, logged in ROADMAP.md): compare those
    # with the angle tolerance alone
    tol = (dict(dtwist=float("inf"), drot=0.05) if kind == "orientation"
           else dict(dtwist=1e-3))

    def flags(scale):
        cfg = {k: v * scale for k, v in tol.items()}
        jp = JProblem(j_m, [jgoal], config=JSolverConfig(**cfg))
        tp = Problem(t_m, [tgoal], config=SolverConfig(**cfg))
        jd = jp.make_data(jnp.asarray(j_m.neutral_q()))
        td = tp.make_data(torch.as_tensor(t_m.neutral_q()))
        for d, lib in ((jd, jnp), (td, torch)):
            grp = d["primary"][0]
            if "position" in grp:
                grp["position"] = lib.asarray(gpos[:, None]) if lib is jnp \
                    else torch.from_numpy(gpos[:, None])
            if "orientation" in grp:
                grp["orientation"] = lib.asarray(gq[:, None]) if lib is jnp \
                    else torch.from_numpy(gq[:, None])
            grp["weight_sq"] = grp["weight_sq"][None]
            if "rotation_scale_sq" in grp:
                grp["rotation_scale_sq"] = grp["rotation_scale_sq"][None]
        jt = jmath.Frame(jnp.asarray(tips.pos.numpy()), jnp.asarray(tips.quat.numpy()))
        jok = np.asarray(jp.check_solution(jt, jnp.asarray(q), jd))
        tok = tp.check_solution(tips, torch.from_numpy(q), td).numpy()
        packed = np.concatenate([tips.pos.numpy(), tips.quat.numpy()], -1)
        jfit = np.asarray(jp.fitness(jnp.asarray(packed), jnp.asarray(q), jd))
        tfit = tp.fitness(torch.from_numpy(packed), torch.from_numpy(q), td).numpy()
        return jok, tok, jfit, tfit

    jok, tok, jfit, tfit = flags(1.0)
    # keep samples ≥ 1 % of the tolerance (≥ 1e-5 for dtwist) from its edge
    stable = (flags(0.99)[0] == jok) & (flags(1.01)[0] == jok)
    assert stable.sum() > 400 and 0.05 < jok[stable].mean() < 0.95
    np.testing.assert_array_equal(tok[stable], jok[stable])
    np.testing.assert_allclose(tfit, jfit, rtol=1e-5, atol=1e-12)


def test_orientation_twist_acceptance():
    """Port-only: the twist test of an orientation goal checks the rotation
    vector of goal⁻¹·tip (the JAX package cannot run it, see above)."""
    t_m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    tp = Problem(t_m, [G.OrientationGoal(link=TIP)],
                 config=SolverConfig(dtwist=1e-3))
    d = tp.make_data(torch.as_tensor(t_m.neutral_q()))
    ang = torch.tensor([5e-4, 2e-3])          # rotation about x, radians
    quat = torch.stack([torch.sin(ang / 2), torch.zeros(2), torch.zeros(2),
                        torch.cos(ang / 2)], -1)[:, None]
    tips = tmath.Frame(torch.zeros(2, 1, 3), quat)
    ok = tp.check_solution(tips, torch.zeros(2, 7), d)
    assert ok.tolist() == [True, False]


def test_non_pose_goal_kinds_raise():
    """The kinds only the unfused solvers evaluate (touch here) raise,
    naming their ROADMAP item; the fused step's kinds build."""
    t_m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    with pytest.raises(NotImplementedError, match="port queue item 5"):
        Problem(t_m, [G.TouchGoal(link=TIP)])
    assert Problem(t_m, [G.LookAtGoal(link=TIP)]).primary[0].kind == "lookat"


def test_scenario_salt_matches_jax(rng):
    keys = rng.integers(0, 1 << 32, size=(1000, 2), dtype=np.uint64).astype(np.uint32)
    j = np.asarray(j_scenario_salt(jnp.asarray(keys)))
    t = _scenario_salt(torch.from_numpy(keys.astype(np.int64))).numpy()
    np.testing.assert_array_equal(t, j.astype(np.int64))


def test_rewrap_matches_jax(rng):
    j_m = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    t_m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    js = JIKSolver(j_m, [JG.PoseGoal(link=TIP)], JSolverConfig())
    ts = IKSolver(t_m, [G.PoseGoal(link=TIP)], SolverConfig())
    b = t_m._np_bounds
    seed = rng.uniform(b["min"], b["max"], size=(256, 7)).astype(np.float32)
    qa = (seed + rng.uniform(-9, 9, size=(256, 7))).astype(np.float32)
    j = np.asarray(js._rewrap(jnp.asarray(qa), jnp.asarray(seed)))
    t = ts._rewrap(torch.from_numpy(qa), torch.from_numpy(seed)).numpy()
    # 2π shifts of angles up to ~12 rad: a few float32 ulps
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
