"""The port's native C++ oracle against the JAX package's (CPU).

``bio_ik_tpu_torch.native`` builds its own copy of the oracle source
(``csrc/native_oracle.cpp``) with the JAX package's g++ flags, so its FK is
held to ``bio_ik_tpu.native.oracle_fk`` bit for bit, and the port's
float64 FK to the oracle within 1e-12 (the pattern of the reference's
RobotFK vs RobotFK_MoveIt comparison, src/ik_test.cpp:92-128).  Without a
C++ toolchain both oracles are unavailable and the tests skip, as the JAX
package's do (``tests/test_native.py``).
"""

import os

import numpy as np
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, native as jnative

from bio_ik_tpu_torch import RobotModel, asset_path, make_fk, native
from tests.test_robot_model import MIMIC_URDF

torch.set_num_threads(1)

ROBOTS = [("pr2_arm.urdf", ["r_gripper_tool_frame"]),
          ("ur5.urdf", ["tool0"]),
          ("humanoid.urdf", ["r_hand", "l_hand", "head"]),
          ("mimic", ["f1", "f2"])]


@pytest.fixture(scope="module")
def oracles():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _models(urdf):
    if urdf == "mimic":
        return RobotModel.from_urdf_string(MIMIC_URDF, device="cpu"), \
            JRobotModel.from_urdf_string(MIMIC_URDF)
    return (RobotModel.from_urdf_file(asset_path(urdf), device="cpu"),
            JRobotModel.from_urdf_file(asset_path(urdf)))


def _qs(m, n=64, seed=0):
    b = m._np_bounds
    return np.random.default_rng(seed).uniform(b["min"], b["max"], size=(n, m.nvars))


@pytest.mark.parametrize("urdf,tips", ROBOTS, ids=[r[0] for r in ROBOTS])
def test_oracle_fk_is_bitwise_the_jax_packages(oracles, urdf, tips):
    """The same source and flags: the same bits (tolerance 0)."""
    m, jm = _models(urdf)
    qs = _qs(m)
    pos, quat = native.oracle_fk(m, qs, tips)
    jpos, jquat = jnative.oracle_fk(jm, qs, tips)
    assert pos.shape == (64, len(tips), 3) and quat.shape == (64, len(tips), 4)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(quat, jquat)


@pytest.mark.parametrize("urdf,tips", ROBOTS, ids=[r[0] for r in ROBOTS])
def test_float64_fk_matches_the_oracle(oracles, urdf, tips):
    """The port's batched FK in float64 on the CPU within 1e-12 of the
    oracle (position; quaternion up to sign), mimic joints applied."""
    m, _ = _models(urdf)
    qs = _qs(m, seed=1)
    pos, quat = native.oracle_fk(m, qs, tips)
    f = make_fk(m, tips)(torch.from_numpy(qs))
    assert f.pos.dtype == torch.float64
    np.testing.assert_allclose(f.pos.numpy(), pos, rtol=0, atol=1e-12)
    sign = np.sign(np.sum(f.quat.numpy() * quat, axis=-1, keepdims=True))
    np.testing.assert_allclose(f.quat.numpy(), sign * quat, rtol=0, atol=1e-12)


def test_float32_fk_matches_the_oracle(oracles):
    """The JAX package's device-FK check (``tests/test_native.py:36-46``) on
    the port's float32 FK: within 3e-6 on PR2 and the humanoid."""
    for urdf, tips in (ROBOTS[0], ROBOTS[2]):
        m, _ = _models(urdf)
        qs = _qs(m, n=256, seed=2).astype(np.float32)
        pos, quat = native.oracle_fk(m, qs, tips)
        f = make_fk(m, tips)(torch.from_numpy(qs))
        np.testing.assert_allclose(f.pos.numpy(), pos, rtol=0, atol=3e-6)
        sign = np.sign(np.sum(f.quat.numpy() * quat, axis=-1, keepdims=True))
        np.testing.assert_allclose(f.quat.numpy(), sign * quat, rtol=0, atol=3e-6)


def test_support_point_matches_jax(oracles):
    """The JAX package's cases, then random hulls and directions against
    the JAX oracle and an argmax of the dot product (tolerance 0)."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3.0]])
    for d, want in (([1.0, 0, 0], 1), ([0, 0, -1.0], 0), ([0, 1.0, 1.0], 3)):
        assert native.support_point(pts, np.array(d)) == want
    rng = np.random.default_rng(3)
    for _ in range(32):
        pts = rng.normal(size=(int(rng.integers(1, 200)), 3))
        d = rng.normal(size=3)
        i = native.support_point(pts, d)
        assert i == jnative.support_point(pts, d) == int(np.argmax(pts @ d))


def test_library_is_built_into_build_native_by_hash(oracles):
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.basename(os.path.dirname(path)) == "native"
    assert os.path.basename(path).startswith("libnative_oracle-")
    with pytest.raises(ValueError):
        native.oracle_fk(_models("ur5.urdf")[0], np.zeros((2, 7)), ["tool0"])
