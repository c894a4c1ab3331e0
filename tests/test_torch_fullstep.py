"""The fullstep kernel's wrapper and the FP32 peak calibration (CPU).

``Fullstep`` (one bio2 step, the port of ``make_fullstep_kernel``) takes
the plain ``make_fullstep_inner`` on CPU tensors, in both randomness modes;
that plain version is held to the JAX package's jnp inner by
``tests/test_torch_megastep.py`` and ``tests/test_torch_secondary.py``
(which the JAX suite holds equal to its interpret-mode kernel,
tests/test_kernel.py:254-293).  The peak calibration's plain version is
held bit for bit to a numpy float32 recurrence: the map is chaotic, so
any other rounding would part from it within ~100 iterations.  The CUDA
kernels are held to these plain versions on the card by ``chip_smoke.py``
and by the ``cuda``-marked tests here.
"""

import numpy as np
import pytest
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_fullstep import array_draw_gen
from bio_ik_tpu_torch.kernels.bio2_megastep import (
    Fullstep,
    fullstep_bytes_per_lane,
    megastep_flops_per_lane,
    philox_draw,
)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs
from bio_ik_tpu_torch.kernels.peak import (
    PeakChains,
    peak_chains_numpy,
    peak_chains_plain,
    peak_flops,
)
from bio_ik_tpu_torch.tools import bench_mfu

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
V = 7
SP = dict(V=V, K=1, C=4, gens=2, mem_iters=2, memetic="q")


def _fullstep(model, sp, N, seed=7):
    state, consts, noise = megastep_inputs(model, TIP, sp, 1, N, seed)
    args = (state[0], state[1]) + tuple(consts[:8])
    return Fullstep(model, [TIP], list(range(V)), [0], sp), args, noise


def test_fullstep_wrapper_takes_the_plain_version_on_cpu():
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    sp = SpeciesParams(**SP)
    fs, args, noise = _fullstep(tm, sp, 128)
    args, noise = tree_from_numpy(args, "cpu"), tree_from_numpy(noise, "cpu")
    Fullstep.launches = 0
    out = fs(*args, noise=noise[0], rates=noise[1])
    ref = fs.inner(*args, array_draw_gen(noise[0], noise[1]))
    assert [tuple(t.shape) for t in out] == [(14, 128), (14, 128), (7, 128), (1, 128)]
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # Philox mode: step word 0 of the megastep's stream
    salt = torch.arange(128, dtype=torch.int32)[None] // 2
    out = fs(*args, seed=21, salt=salt)
    ref = fs.inner(*args, philox_draw(21, salt, V, sp.C)(0)[0])
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert Fullstep.launches == 0
    assert bool(torch.isfinite(out[3]).all())
    with pytest.raises(ValueError, match="seed"):
        fs(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs(*(a.to("meta") for a in args), noise=noise[0], rates=noise[1])


def test_fullstep_cost_model():
    """One step at the main path's phase-1 lanes (131 072, V = 7, K = 1):
    23 428 FLOPs per lane (0.046 ms at 67 TFLOP/s) and, with noise tensors,
    4 408 bytes per lane (0.172 ms at 3.35 TB/s) — the TPU kernel's cost
    estimate (bio2_fullstep.py:681-682, :705-706)."""
    sp = SpeciesParams(V=7, K=1)
    assert megastep_flops_per_lane(sp, 1) == 23428
    assert fullstep_bytes_per_lane(sp, 0) == 4408
    N = 131072
    assert abs(fullstep_bytes_per_lane(sp, 0) * N / 3.35e12 * 1e3 - 0.172) < 1e-3
    assert abs(megastep_flops_per_lane(sp, 1) * N / 67e12 * 1e3 - 0.0458) < 1e-3


def test_bench_mfu_counts_the_engine_like_the_jax_tool():
    """bench_mfu's solver gives the JAX tool's 23 428 useful FLOPs per step
    and lane (tools/bench_mfu.py:109-115)."""
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    s = IKSolver(tm, [G.PoseGoal(link=bench_mfu.TIP)],
                 SolverConfig(mode="bio2_memetic", max_steps=bench_mfu.SPC,
                              steps_per_check=bench_mfu.SPC))
    assert megastep_flops_per_lane(s.engine.sp, 1) == 23428


@pytest.mark.parametrize("T", [0, 1, 64, 200])
def test_peak_plain_version_is_the_numpy_recurrence(T):
    x = np.random.default_rng(0).uniform(0.2, 0.8, size=(32, 256)).astype(np.float32)
    out = peak_chains_plain(torch.from_numpy(x), T, 64).numpy()
    np.testing.assert_array_equal(out, peak_chains_numpy(x, T, 64))
    assert out.shape == (32, 64)


def test_peak_wrapper_takes_the_plain_version_on_cpu():
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.2, 0.8, size=(16, 128)).astype(np.float32))
    PeakChains.launches = 0
    assert torch.equal(PeakChains()(x, 32, 32), peak_chains_plain(x, 32, 32))
    assert PeakChains.launches == 0
    with pytest.raises(ValueError, match="multiple"):
        PeakChains()(x, 32, 48)
    assert peak_flops(256, 8192, 3072) == 3 * 256 * 8192 * 8 * 3072


@pytest.mark.cuda
def test_fullstep_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    sp = SpeciesParams(V=7, K=1)
    fs, args, noise = _fullstep(tm, sp, 4096)
    args, noise = tree_from_numpy(args, "cuda"), tree_from_numpy(noise, "cuda")
    before = Fullstep.launches
    out = fs(*args, noise=noise[0], rates=noise[1])
    ref = fs.inner(*args, array_draw_gen(noise[0], noise[1]))
    salt = torch.arange(4096, dtype=torch.int32, device="cuda")[None] // 2
    out2 = fs(*args, seed=3, salt=salt)
    ref2 = fs.inner(*args, philox_draw(3, salt, V, sp.C)(0)[0])
    torch.cuda.synchronize()
    assert Fullstep.launches == before + 2
    assert lane_agreement(out, ref).float().mean() >= 0.85
    assert lane_agreement(out2, ref2).float().mean() >= 0.85


@pytest.mark.cuda
def test_peak_cuda_kernel_is_bitwise_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0.2, 0.8, size=(256, 512 * 4)).astype(np.float32), device="cuda")
    out = PeakChains()(x, 64, 512)
    assert torch.equal(out, peak_chains_plain(x, 64, 512))
