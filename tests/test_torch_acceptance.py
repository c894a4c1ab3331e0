"""The ``drot`` acceptance at small angles against the JAX package (CPU).

Table B's 64 PR2 targets (``default_rng(42)`` uniform in the bounds, the
port's FK), each rotated by 1.0 mrad and by 0.2 mrad about a random axis,
checked at ``drot`` = 0.03° (5.24e-4 rad): the port, in float32 and in
float64, rejects every 1 mrad row and accepts every 0.2 mrad row, and its
decisions equal the JAX package's ``check_solution`` in float64 on the
same unit quaternions; and in float32 on FK's own quaternions.  The port
reads the angle as 2·atan2(‖v‖, |w|) of tip⁻¹·goal; the JAX package's
clamped arccos of the dot reads 0 below ~1 mrad in float32 once FK's
rounding leaves the quaternions' norms above 1, as on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import bio_ik_tpu.goals as JG
from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.api import IKSolver as JIKSolver
from bio_ik_tpu.config import SolverConfig as JSolverConfig
from bio_ik_tpu.math.frame import Frame as JFrame

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.math.frame import Frame

torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
N = 64
DROT_DEG = 0.03


def _rotated(quat, theta, rng):
    """``quat (N, 4)`` (xyzw) composed with a rotation of ``theta`` about a
    random unit axis per row, in float64."""
    axis = rng.normal(size=(quat.shape[0], 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    r = np.concatenate([axis * np.sin(theta / 2), np.full((quat.shape[0], 1),
                                                           np.cos(theta / 2))], -1)
    x1, y1, z1, w1 = quat.T
    x2, y2, z2, w2 = r.T
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def test_drot_acceptance_at_small_angles_matches_jax():
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    b = m._np_bounds
    qg = np.random.default_rng(42).uniform(b["min"], b["max"], (N, m.nvars))
    tg = make_fk(m, [TIP])(torch.as_tensor(qg.astype(np.float32)))
    gpos = tg.pos[:, 0].double().numpy()
    gquat = tg.quat[:, 0].double().numpy()
    # unit in float64: the JAX package's arccos reads the norms' product
    # too, and float32 FK leaves them ~1e-7 off 1 (1 mrad moves the dot by
    # 1.25e-7)
    gquat /= np.linalg.norm(gquat, axis=-1, keepdims=True)
    rng = np.random.default_rng(9)
    tips = np.concatenate([_rotated(gquat, 1.0e-3, rng), _rotated(gquat, 0.2e-3, rng)])
    pos = np.concatenate([gpos, gpos])
    want = np.arange(2 * N) >= N               # reject 1 mrad, accept 0.2 mrad
    cfg = dict(mode="bio2_memetic", drot=DROT_DEG, dtwist=float("inf"))

    for dtype in ("float32", "float64"):
        s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(dtype=dtype, **cfg))
        tdt = s.problem.tdtype
        d = tree_map(lambda x: x.expand((2 * N,) + x.shape).clone(),
                     s.make_data(torch.as_tensor(m.neutral_q())))
        d["primary"][0]["position"] = torch.as_tensor(pos[:, None], dtype=tdt)
        d["primary"][0]["orientation"] = torch.as_tensor(
            np.concatenate([gquat, gquat])[:, None], dtype=tdt)
        ok = s.problem.check_solution(
            Frame(pos=torch.as_tensor(pos[:, None], dtype=tdt),
                  quat=torch.as_tensor(tips[:, None], dtype=tdt)),
            d["seed_active"], d).numpy()
        np.testing.assert_array_equal(ok, want, err_msg=dtype)

    with jax.enable_x64(True):
        jm = JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
        js = JIKSolver(jm, [JG.PoseGoal(link=TIP)],
                       JSolverConfig(dtype="float64", fused="off", **cfg))
        jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (2 * N,) + x.shape),
                          js.make_data(jnp.asarray(jm.neutral_q())))
        jd["primary"][0]["position"] = jnp.asarray(pos[:, None])
        jd["primary"][0]["orientation"] = jnp.asarray(np.concatenate([gquat, gquat])[:, None])
        jok = np.asarray(js.problem.check_solution(
            JFrame(pos=jnp.asarray(pos[:, None]), quat=jnp.asarray(tips[:, None])),
            jd["seed_active"], jd))
    np.testing.assert_array_equal(ok, jok)

    # float32 on FK's own quaternions, whose norms are off 1 (as on the card)
    raw = tg.quat[:, 0].double().numpy()
    rng = np.random.default_rng(9)
    tips = np.concatenate([_rotated(raw, 1.0e-3, rng), _rotated(raw, 0.2e-3, rng)])
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(**cfg))
    d = tree_map(lambda x: x.expand((2 * N,) + x.shape).clone(),
                 s.make_data(torch.as_tensor(m.neutral_q())))
    d["primary"][0]["position"] = torch.as_tensor(pos[:, None], dtype=torch.float32)
    d["primary"][0]["orientation"] = torch.cat([tg.quat, tg.quat])
    ok = s.problem.check_solution(
        Frame(pos=d["primary"][0]["position"],
              quat=torch.as_tensor(tips[:, None], dtype=torch.float32)),
        d["seed_active"], d).numpy()
    np.testing.assert_array_equal(ok, want)
