"""The port's species tier against the JAX package (CPU).

The plain ``make_species_inner`` is held to the JAX package's jitted jnp
inner — which the JAX suite holds equal to its interpret-mode Pallas kernel
(tests/test_kernel.py:59-60) — on identical inputs and noise tensors made
with numpy (``kernels/checks.species_inputs``), per lane: a last-bit
difference in the memetic line search (a quotient of differences of nearly
equal fitness values) sends a lane down another, equally valid, trajectory,
so ≥ 90 % of lanes must agree within rtol 1e-5 (measured 99–100 %).

The engine's species-tier bookkeeping is held to a numpy transcription of
the JAX engine (engine.py:736-784) on injected values; the whole tier runs
end to end on the CPU, once against the JAX engine on ``planar_arm`` (the
floating arm's JAX solve compiles for ~40 s and is marked slow).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bio_ik_tpu.goals as JG
from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.api import IKSolver as JIKSolver
from bio_ik_tpu.config import SolverConfig as JSolverConfig
from bio_ik_tpu.kernels.bio2_step import (SpeciesParams as JSpeciesParams,
                                          make_species_inner as j_make_species_inner)

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import (AdaptiveBatchSolver, IKSolver, RobotModel,
                              SolverConfig, make_fk)
from bio_ik_tpu_torch.engine import FusedBio2Engine
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import (MEGASTEP_GROUPS,
                                                    MEGASTEP_SOURCES, philox_draw)
from bio_ik_tpu_torch.kernels.bio2_step import (SPECIES_SHAPES, SpeciesKernel,
                                                SpeciesParams, make_species_inner,
                                                species_bytes_per_lane,
                                                species_flops_per_lane,
                                                species_philox_calls_per_lane)
from bio_ik_tpu_torch.kernels.build import CSRC
from bio_ik_tpu_torch.kernels.checks import lane_agreement, species_inputs

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

CFG = dict(mode="bio2_memetic", dpos=5e-3, dtwist=float("inf"), max_steps=16)


def _model(name):
    return RobotModel.from_urdf_file(asset_path(name), device="cpu")


@pytest.mark.parametrize("name,quat,memetic", [
    ("free_arm.urdf", (3,), "q"),
    ("planar_arm.urdf", (), "l"),
    ("free_arm.urdf", (3,), ""),
])
def test_species_inner_matches_jax(name, quat, memetic):
    tm = _model(name)
    sp = dict(V=tm.nvars, K=1, C=4, gens=2, mem_iters=2, memetic=memetic,
              quat_slices=quat)
    args = species_inputs(tm, "tool", SpeciesParams(**sp), 256)
    out = make_species_inner(SpeciesParams(**sp))(*tree_from_numpy(args, "cpu"))
    ref = jax.jit(j_make_species_inner(JSpeciesParams(**sp)))(
        *[jnp.asarray(a) for a in args])
    agree = lane_agreement(out, [np.asarray(r) for r in ref])
    assert agree.float().mean() >= 0.9


def test_species_kernel_wrapper_dispatch():
    tm = _model("planar_arm.urdf")
    sp = SpeciesParams(V=5, K=1, gens=2, mem_iters=2)
    args = tree_from_numpy(species_inputs(tm, "tool", sp, 64), "cpu")
    kern = SpeciesKernel(sp)
    SpeciesKernel.launches = 0
    out = kern(*args)
    for a, b in zip(out, kern.inner(*args)):
        assert torch.equal(a, b)
    assert SpeciesKernel.launches == 0          # the plain version ran
    with pytest.raises(ValueError):
        kern(*(a.to("meta") for a in args))
    with pytest.raises(ValueError):
        SpeciesKernel(SpeciesParams(V=5, K=1, quat_slices=(3,)))


def test_species_cost_model():
    """The slice's launch (free_arm, V=10, K=1): 29 920 FLOPs and 6 416
    bytes per lane (the TPU kernel's cost estimate plus the goal rows) with
    noise tensors, 788 in Philox mode (the salt in place of the noise and
    rates), and 8 × (16·8 + 1) = 1 032 Philox calls."""
    sp = SpeciesParams(V=10, K=1)
    assert species_flops_per_lane(sp) == 29920
    assert species_bytes_per_lane(sp) == 6416
    assert species_bytes_per_lane(sp, rng="philox") == 788
    assert species_bytes_per_lane(sp, ("beta",), rng="philox") == 788 + 4 * 80
    assert species_bytes_per_lane(sp, ("beta",)) == 6416 + 4 * (8 + 80)
    assert species_philox_calls_per_lane(sp) == 1032
    assert species_philox_calls_per_lane(sp, "box_muller") == 8 * (160 + 1)
    assert species_philox_calls_per_lane(SpeciesParams(V=5, K=1)) == 8 * (16 * 4 + 1)


def _np_book(f, qa_bis, tips_bis, genes, grads, sfit, solution, sol_fit,
             sol_tips, wipe_u, wipe_g, amin, amax):
    """numpy transcription of the JAX engine's step bookkeeping
    (engine.py:736-784)."""
    B, I, S = f.shape
    V = qa_bis.shape[-1]
    T = sol_tips.shape[2]
    M = B * I * S
    improved = f != sfit
    s_best = np.argmin(f, axis=-1)
    bi, ii = np.meshgrid(np.arange(B), np.arange(I), indexing="ij")
    f_best = f[bi, ii, s_best]
    better = f_best < sol_fit
    solution = np.where(better[..., None], qa_bis[bi, ii, s_best], solution)
    sol_tips = np.where(better[..., None, None],
                        tips_bis[bi, ii, s_best].reshape(B, I, T, 7), sol_tips)
    sol_fit = np.where(better, f_best, sol_fit)
    swap = f[..., 1] < f[..., 0]

    def sswap(x):
        xr = x.reshape(-1, B, I, S)
        return np.where(swap[None, :, :, None], xr[..., ::-1], xr).reshape(-1, M)

    genes, grads = sswap(genes), sswap(grads)
    f = np.where(swap[..., None], f[..., ::-1], f)
    improved = np.where(swap[..., None], improved[..., ::-1], improved)
    wipe = (wipe_u < 0.1) | ~improved[..., 1]
    rand_genes = amin + wipe_g * (amax - amin)
    gr = genes.reshape(2, V, B, I, S).copy()
    gr[..., 1] = np.where(wipe[None, None], np.transpose(rand_genes, (2, 0, 1))[None],
                          gr[..., 1])
    rr = grads.reshape(2, V, B, I, S).copy()
    rr[..., 1] = np.where(wipe[None, None], 0.0, rr[..., 1])
    return gr.reshape(2 * V, M), rr.reshape(2 * V, M), f, solution, sol_fit, sol_tips


def test_species_bookkeeping_matches_jax_transcription(rng):
    B, I, S, V, T = 6, 3, 2, 5, 1
    f32 = np.float32
    # ties between the two species and unchanged fitness (no improvement)
    # on purpose
    f = rng.choice([0.1, 0.2, 0.3], size=(B, I, S)).astype(f32)
    sfit = np.where(rng.uniform(size=(B, I, S)) < 0.4, f, f + 1).astype(f32)
    vals = (
        f, rng.normal(size=(B, I, S, V)).astype(f32),
        rng.normal(size=(B, I, S, 7 * T)).astype(f32),
        rng.normal(size=(2 * V, B * I * S)).astype(f32),
        rng.normal(size=(2 * V, B * I * S)).astype(f32), sfit,
        rng.normal(size=(B, I, V)).astype(f32),
        rng.choice([0.05, 0.25], size=(B, I)).astype(f32),
        rng.normal(size=(B, I, T, 7)).astype(f32),
        rng.uniform(size=(B, I)).astype(f32),
        rng.uniform(size=(B, I, V)).astype(f32),
        np.full(V, -1.0, f32), np.full(V, 2.0, f32),
    )
    out = FusedBio2Engine._species_book(*tree_from_numpy(vals, "cpu"))
    ref = _np_book(*vals)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def _batch(model, solver, B):
    """The JAX suite's floating-base row: targets from FK of
    ``default_rng(0)`` uniform draws in the bounds, seeded at neutral_q."""
    b = model._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(B, model.nvars)).astype(np.float32)
    tg = make_fk(model, ["tool"])(torch.from_numpy(qg))
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                    solver.make_data(torch.as_tensor(model.neutral_q())))
    data["primary"][0]["position"] = tg.pos.contiguous()
    keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                        torch.arange(B, dtype=torch.int64)], -1)
    return data, keys, tg


def _pos_err(model, q, tg):
    return (make_fk(model, ["tool"])(q).pos[:, 0] - tg.pos[:, 0]).norm(dim=-1)


def test_species_draws_injected_and_own(rng):
    """Injected noise tensors replace the engine's own stream; the engine's
    own draws are the megastep tier's Philox stream (``philox_draw`` at the
    chunk's seed, the step within the chunk and the lane): deterministic,
    another per step, the rate ladder, and a fresh scenario key changes
    only that scenario's lanes and islands."""
    tm = _model("planar_arm.urdf")
    s = IKSolver(tm, [G.PositionGoal(link="tool")],
                 SolverConfig(**dict(CFG, max_steps=4, islands=2)))
    eng = s.engine
    assert not eng.fullstep and isinstance(eng.kernel, SpeciesKernel)
    B, M = 3, 3 * 2 * 2
    data, keys, _ = _batch(tm, s, B)
    sp = eng.sp
    calls = []

    def draws(step):
        calls.append(step)
        r = np.random.default_rng(step)
        k = r.integers(0, 16, size=(sp.gens, sp.C, M))
        return tree_from_numpy((
            r.standard_normal((sp.gens, sp.V, sp.C, M), dtype=np.float32),
            np.exp2(k - 23.0).astype(np.float32),
            r.uniform(size=(B, 2)).astype(np.float32),
            r.uniform(size=(B, 2, sp.V)).astype(np.float32)), "cpu")

    a = eng._species_solve(keys, data, draws)
    assert calls == [0, 1, 2, 3]
    b = eng._species_solve(keys, data, draws)
    own = eng._species_solve(keys, data)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.q, own.q)
    # the engine's own draws: the kernel's Philox arguments and the
    # islands' wipe words, those of philox_draw at the same counters
    salt_row = eng._lane_setup(keys, data)["salt_row"]
    kw, wipe_u, wipe_g = eng._species_stream(0, 1, salt_row)
    assert kw["seed"] == eng._chunk_seed(0) and kw["step"] == 1
    assert kw["salt"] is salt_row and tuple(wipe_u.shape) == (B, 2)
    d0 = eng.kernel.philox_tensors(kw["seed"], 1, salt_row)
    assert [tuple(x.shape) for x in d0[:2]] == [(sp.gens, 5, sp.C, M),
                                                (sp.gens, sp.C, M)]
    draw_gen, mu, mg = philox_draw(kw["seed"], salt_row, sp.V, sp.C)(1)
    for g in range(sp.gens):
        assert all(torch.equal(x[g], y) for x, y in zip(d0[:2], draw_gen(g)))
    # each island's second species lane (the lane the megastep wipes)
    assert torch.equal(wipe_u.reshape(1, -1), mu[:, 1::2])
    assert torch.equal(wipe_g.reshape(-1, sp.V).T, mg[:, 1::2])
    for x, y in zip(d0[:2], eng.kernel.philox_tensors(kw["seed"], 1, salt_row)):
        assert torch.equal(x, y)
    assert not torch.equal(d0[0], eng.kernel.philox_tensors(kw["seed"], 2, salt_row)[0])
    k = torch.log2(d0[1]) + 23
    assert bool((k == k.round()).all()) and 0 <= int(k.min()) and int(k.max()) <= 15
    keys2 = keys.clone()
    keys2[1, 1] = 999                           # scenario 1: lanes 4..7
    salt_row2 = eng._lane_setup(keys2, data)["salt_row"]
    changed = (eng.kernel.philox_tensors(kw["seed"], 1, salt_row2)[0] != d0[0]) \
        .reshape(-1, M).any(0)
    assert changed.nonzero().flatten().tolist() == [4, 5, 6, 7]
    _, wipe_u2, wipe_g2 = eng._species_stream(0, 1, salt_row2)
    moved = (wipe_u2 != wipe_u) | (wipe_g2 != wipe_g).any(-1)
    assert moved.nonzero().tolist() == [[1, 0], [1, 1]]


def test_free_arm_solve_batch_cpu():
    """The slice's configuration end to end on the CPU at B = 16: success,
    determinism, a fresh key changes its scenario only, and a single
    query's floating quaternion is unit within 1e-2
    (tests/test_floating.py:82-84)."""
    tm = _model("free_arm.urdf")
    s = IKSolver(tm, [G.PositionGoal(link="tool")], SolverConfig(**CFG))
    assert s.engine.sp.quat_slices == (3,) and not s.engine.fullstep
    data, keys, tg = _batch(tm, s, 16)
    SpeciesKernel.launches = 0
    res = s.solve_batch(keys, data)
    assert SpeciesKernel.launches == 0          # CPU: the plain version
    assert bool(res.success.all())
    assert float(_pos_err(tm, res.q, tg).median()) <= 5e-4
    keys2 = keys.clone()
    keys2[5, 1] = 999
    other = s.solve_batch(keys2, data)
    same = torch.stack([(a == b).reshape(16, -1).all(1)
                        for a, b in zip(res, other)]).all(0)
    assert same.tolist() == [i != 5 for i in range(16)]
    qn = float(res.q[0, 3:7].norm())
    assert abs(qn - 1.0) < 1e-2, qn


def _against_jax(name, B):
    """The same targets (from the port's FK) through both engines; both
    results measured with the port's FK."""
    tm = _model(name)
    ts = IKSolver(tm, [G.PositionGoal(link="tool")], SolverConfig(**CFG))
    data, keys, tg = _batch(tm, ts, B)
    res = ts.solve_batch(keys, data)
    jm = JRobotModel.from_urdf_file(asset_path(name))
    js = JIKSolver(jm, [JG.PositionGoal(link="tool")],
                   JSolverConfig(fused="auto", **CFG))
    assert js.engine is not None and not js.engine.fullstep
    d0 = js.make_data(jnp.asarray(jm.neutral_q()))
    jdata = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    jdata["primary"][0]["position"] = jnp.asarray(tg.pos.numpy())
    jres = js.solve_batch(jax.random.split(jax.random.PRNGKey(0), B), jdata)
    j_success = float(np.asarray(jres.success).mean())
    jerr = _pos_err(tm, torch.from_numpy(np.array(jres.q)), tg)
    assert float(res.success.float().mean()) >= j_success - 0.05
    assert float(_pos_err(tm, res.q, tg).median()) <= 5e-4
    assert float(jerr.median()) <= 5e-3           # the JAX path solves them too


def test_planar_arm_matches_jax():
    _against_jax("planar_arm.urdf", 64)


@pytest.mark.slow
def test_free_arm_matches_jax():
    _against_jax("free_arm.urdf", 64)


def test_adaptive_species_tier():
    tm = _model("planar_arm.urdf")
    s = AdaptiveBatchSolver(tm, [G.PositionGoal(link="tool")], SolverConfig(**CFG),
                            phases=((1, 2), (2, 2)), fractions=(0.5,))
    assert all(not x.engine.fullstep for x in s.solvers)
    data, keys, tg = _batch(tm, s.solvers[0], 4)
    res = s.solve_batch(keys, data)
    seed_fit = s.solvers[0].ctx.fitness_exact(data["seed_active"], data)
    assert bool((res.fitness <= seed_fit).all())
    fk = make_fk(tm, ["tool"])
    p = s.problem
    assert torch.equal(p.check_solution(fk(res.q), res.qa, data), res.success)
    for a, b in zip(res, s.solve_batch(keys, data)):
        assert torch.equal(a, b)


def test_kernel_shape_gap_is_rejected():
    """On a card, a (V, K, T) that no CUDA source instantiates is rejected
    at construction, naming the shape and the ROADMAP item."""
    def on_card(solver):
        solver.problem.device = torch.device("cuda")   # metadata only
        return FusedBio2Engine.supports(solver)

    snake = _model("snake.urdf")
    s = IKSolver(snake, [G.PositionGoal(link="head")], fixed_joints=[snake.joint_names[2]])
    assert FusedBio2Engine.supports(s) is None          # CPU: plain version
    reason = on_card(s)
    assert "(31, 1, 1)" in reason and "queue item 9" in reason
    free = _model("free_arm.urdf")
    s = IKSolver(free, [G.PositionGoal(link="tool")], fixed_joints=["j3"])
    reason = on_card(s)
    assert "species" in reason and "(9, 1)" in reason and "queue item 9" in reason
    for name, tip in (("free_arm.urdf", "tool"), ("planar_arm.urdf", "tool"),
                      ("pr2_arm.urdf", "r_gripper_tool_frame")):
        assert on_card(IKSolver(_model(name), [G.PoseGoal(link=tip)])) is None
    # the Python lists name exactly the instances of the CUDA sources, and
    # the group sizes each megastep source builds
    sources = [(f"{name}.cu", shapes) for name, shapes in MEGASTEP_SOURCES.items()]
    for src, shapes in sources + [("species.cu", SPECIES_SHAPES)]:
        with open(f"{CSRC}/{src}") as fh:
            text = fh.read()
        line = re.search(r"#define SHAPES\(X\)(.*)", text).group(1)
        found = tuple(tuple(int(x) for x in m.split(","))
                      for m in re.findall(r"X\(([^)]*)\)", line))
        assert found == shapes
        if src != "species.cu":
            line = re.search(r"#define GROUPS\(X, v, k, t\)(.*)", text).group(1)
            groups = tuple(int(m.split(",")[-1]) for m in re.findall(r"X\(([^)]*)\)", line))
            assert groups == MEGASTEP_GROUPS[src[:-3]]


@pytest.mark.cuda
def test_species_cuda_kernel_matches_plain_version():
    """The hand-written species kernel against the plain version on the
    card, on identical noise tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = _model("free_arm.urdf")
    sp = SpeciesParams(V=10, K=1, quat_slices=(3,))
    args = tree_from_numpy(species_inputs(tm, "tool", sp, 4096), "cuda")
    kern = SpeciesKernel(sp)
    before = SpeciesKernel.launches
    out = kern(*args)
    ref = kern.inner(*args)
    torch.cuda.synchronize()
    assert SpeciesKernel.launches == before + 1
    assert lane_agreement(out, ref).float().mean() >= 0.85
