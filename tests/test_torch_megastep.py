"""The port's fused-step modules against the JAX package (CPU).

``FkRows``, the plain ``make_fullstep_inner`` and ``make_megastep_body``
of ``bio_ik_tpu_torch`` against the JAX package's plain-jnp bodies run
eagerly (``use_pltpu_roll=False``), on identical inputs and noise tensors
made with numpy (``kernels/checks.megastep_inputs``), at the sizes of the
JAX package's own check (C=4, gens=2, mem_iters=2, n_steps=2, N=256).

Agreement is per lane: the two sides round sin/cos differently, and the
memetic line search divides differences of nearly equal fitness values,
so a last-bit difference can send a lane down another (equally valid)
trajectory.  Measured: the full state agrees (rtol 1e-5) on 98.8 % of
lanes for a solve under way (parents 1e-3 rad from a target), 55 % at
1e-2 rad and 15 % at 0.2 rad, while every single stage agrees on all lanes.
The CUDA kernel is held to the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.kernels.bio2_fullstep import (
    array_draw_gen as j_array_draw_gen,
    make_fullstep_inner as j_make_fullstep_inner,
)
from bio_ik_tpu.kernels.bio2_megastep import make_megastep_body as j_make_megastep_body
from bio_ik_tpu.kernels.bio2_step import SpeciesParams as JSpeciesParams
from bio_ik_tpu.kernels.fk_rows import FkRows as JFkRows

from bio_ik_tpu_torch import RobotModel
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_to_numpy
from bio_ik_tpu_torch.kernels.bio2_fullstep import (
    array_draw_gen,
    make_fullstep_inner,
    philox4x32,
)
from bio_ik_tpu_torch.kernels.bio2_megastep import (
    Megastep,
    array_draw,
    make_megastep_body,
    philox_draw,
)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs
from bio_ik_tpu_torch.kernels.fk_rows import FkRows

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
V = 7
N = 256
NSTEPS = 2
SP = dict(V=V, K=1, C=4, gens=2, mem_iters=2, memetic="q")


@pytest.fixture(scope="module")
def models():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


@pytest.fixture(scope="module")
def inputs(models):
    return megastep_inputs(models[1], TIP, SpeciesParams(**SP), NSTEPS, N)


def _comp_np(c, n):
    return np.full(n, c, np.float32) if isinstance(c, float) else np.asarray(c)[0]


def test_fk_rows_match_jax(models, rng):
    jm, tm = models
    q = rng.uniform(tm._np_bounds["min"], tm._np_bounds["max"],
                    size=(64, V)).astype(np.float32)
    jf, tf = JFkRows(jm, [TIP], list(range(V))), FkRows(tm, [TIP], list(range(V)))
    assert jf.fixed_vars == tf.fixed_vars == []
    jfr = jf.frames([jnp.asarray(q[:, v][None]) for v in range(V)], [])
    tfr = tf.frames([torch.from_numpy(q[:, v][None]) for v in range(V)], [])
    # float32 FK over a ~1 m chain: a few ulps
    for (jp, jq), (tp, tq) in zip(jf.tips(jfr), tf.tips(tfr)):
        for a, b in zip(jp + jq, tp + tq):
            np.testing.assert_allclose(_comp_np(b, 64), _comp_np(a, 64), atol=1e-5)
    for jd, td in zip(jf.deltas(jfr), tf.deltas(tfr)):
        (jp, jq), (tp, tq) = jd[0], td[0]
        for a, b in zip(jp + jq, tp + tq):
            np.testing.assert_allclose(_comp_np(b, 64), _comp_np(a, 64), atol=1e-5)


def test_fk_rows_chain_arrays_describe_the_schedule(models):
    _, tm = models
    link_i, link_f, tip_slot = FkRows(tm, [TIP], list(range(V))).chain_arrays()
    sched = tm.link_schedule([tm.link_index[TIP]])
    assert link_i.shape == (len(sched), 6) and link_f.shape == (len(sched), 19)
    assert tip_slot.tolist() == [sched.index(tm.link_index[TIP])]
    # every active variable drives exactly one moving joint of the tip
    moving = link_i[link_i[:, 4] != 0]
    assert sorted(moving[:, 3].tolist()) == list(range(V))


def _fullstep_args(state, consts):
    return (state[0], state[1]) + tuple(consts[:8])


def test_fullstep_inner_matches_jax(models, inputs):
    jm, tm = models
    state, consts, noise = inputs
    tinner, _ = make_fullstep_inner(tm, [TIP], list(range(V)), [0],
                                    SpeciesParams(**SP))
    jinner, _ = j_make_fullstep_inner(jm, [TIP], list(range(V)), [0],
                                      JSpeciesParams(**SP))
    args = _fullstep_args(state, consts)
    t_out = tinner(*tree_from_numpy(args, "cpu"), array_draw_gen(
        *tree_from_numpy(noise[:2], "cpu")))
    j_out = jinner(*[jnp.asarray(a) for a in args],
                   j_array_draw_gen(jnp.asarray(noise[0]), jnp.asarray(noise[1])))
    agree = lane_agreement(t_out, [np.asarray(x) for x in j_out])
    assert agree.float().mean() >= 0.9


def test_megastep_body_matches_jax(models, inputs):
    jm, tm = models
    state, consts, noise = inputs
    body, F = make_megastep_body(tm, [TIP], list(range(V)), [0],
                                 SpeciesParams(**SP), NSTEPS)
    jbody, jF = j_make_megastep_body(jm, [TIP], list(range(V)), [0],
                                     JSpeciesParams(**SP), NSTEPS,
                                     use_pltpu_roll=False, unroll=True)
    assert F == jF == 0
    t_out = body(tree_from_numpy(state, "cpu"), tree_from_numpy(consts, "cpu"),
                 array_draw(*tree_from_numpy(noise, "cpu"), SP["gens"]))
    jn = [jnp.asarray(x) for x in noise]

    def draw(i):
        g0 = i * SP["gens"]
        return (j_array_draw_gen(jn[0][g0:g0 + SP["gens"]], jn[1][g0:g0 + SP["gens"]]),
                jn[2][i], jn[3][i])

    j_out = [np.asarray(x) for x in jbody(
        tuple(jnp.asarray(x) for x in state),
        tuple(jnp.asarray(x) for x in consts), draw)]
    agree = lane_agreement(t_out, j_out)
    # measured 0.988 (module docstring)
    assert agree.float().mean() >= 0.9
    # exact-FK incumbent tips and fitness wherever the incumbent genes agree
    sol_ok = lane_agreement([t_out[3]], [j_out[3]])
    assert sol_ok.float().mean() >= 0.9
    tips_ok = lane_agreement([t_out[4], t_out[5]], [j_out[4], j_out[5]],
                             rtol=1e-5, atol=1e-5)
    assert bool(tips_ok[sol_ok].all())


def test_wrapper_takes_the_plain_version_on_cpu(models, inputs):
    _, tm = models
    state, consts, noise = tree_from_numpy(inputs, "cpu")
    sp = SpeciesParams(**SP)
    mega = Megastep(tm, [TIP], list(range(V)), [0], sp, NSTEPS)
    Megastep.launches = 0
    out = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
               wipe_g=noise[3])
    ref = mega.body(state, consts, array_draw(*noise, sp.gens))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    salt = torch.arange(N, dtype=torch.int32)[None] // 2
    out1 = mega(state, consts, seed=5, salt=salt)
    out2 = mega(state, consts, seed=5, salt=salt)
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)
    assert Megastep.launches == 0
    with pytest.raises(ValueError):
        mega(state, consts)


def test_philox_known_answers():
    """Philox4x32-10 against the published known-answer vectors
    (Salmon et al., Random123 kat_vectors)."""
    def run(ctr, key):
        c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
        return [int(w) for w in philox4x32(*c, *key)]

    assert run([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D,
                                          0xBC57AC4C, 0x9B00DBD8]
    assert run([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
               [0xA4093822, 0x299F31D0]) == [0xD16CFE09, 0x94FDCCEB,
                                              0x5001E420, 0x24126EA1]


def test_philox_draw_statistics_and_salt():
    salt = torch.zeros((1, 4096), dtype=torch.int32)
    draw_gen, wu, wg = philox_draw(9, salt, V, 16)(0)
    noise, rates = draw_gen(0)
    # clt4: unit variance, zero mean (7·16·4096 = 458 752 draws)
    assert abs(noise.mean().item()) < 0.01 and abs(noise.var().item() - 1) < 0.02
    k = torch.log2(rates).round() + 23
    assert int(k.min()) == 0 and int(k.max()) == 15
    assert 0.0 <= float(wu.min()) and float(wg.max()) < 1.0
    salt2 = salt.clone()
    salt2[0, 10] = 12345
    noise2, _ = philox_draw(9, salt2, V, 16)(0)[0](0)
    changed = (noise2 != noise).reshape(-1, 4096).any(0)
    assert changed.nonzero().flatten().tolist() == [10]


def test_interop_round_trip(inputs):
    back = tree_to_numpy(tree_from_numpy(inputs, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(inputs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(models):
    """The hand-written kernel against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    sp = SpeciesParams(**SP)
    state, consts, noise = tree_from_numpy(
        megastep_inputs(tm, TIP, sp, NSTEPS, 4096), "cuda")
    mega = Megastep(tm, [TIP], list(range(V)), [0], sp, NSTEPS)
    out = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
               wipe_g=noise[3])
    ref = mega.body(state, consts, array_draw(*noise, sp.gens))
    torch.cuda.synchronize()
    assert lane_agreement(out, ref).float().mean() >= 0.85
