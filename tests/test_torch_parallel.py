"""The port's multi-process sharding (``bio_ik_tpu_torch.parallel``) on the
CPU, over gloo.

The winner reduction and the lane migration are held to the JAX package's
(``bio_ik_tpu/parallel/islands.py``: ``_pick_winner`` itself; a numpy
transcription of the nested ``_inject_lanes``, :157-176) exactly.  The
sharded solves run through ``tools/parallel_check`` at a small size: in a
world of one they are bitwise the single-card solves (the fused engine's
plain megastep, the island path, the batch); in a two-process world the
batch-sharded result is bitwise the two halves' ``solve_batch`` and the
island-sharded solve with migration is the same on both ranks and better
than the seed.  The mesh helpers take the cases of the JAX package's
``tests/test_islands.py:147-158`` at the port's world size.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from bio_ik_tpu.parallel.islands import _pick_winner as j_pick_winner

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.parallel.distributed import (initialize_distributed,
                                                   local_batch_slice, make_pod_mesh)
from bio_ik_tpu_torch.parallel.islands import (_inject_lanes, _pick_winner, default_mesh,
                                               make_sharded_batch_solve)
from bio_ik_tpu_torch.tools import parallel_check

torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
NAN, INF = float("nan"), float("inf")

WINNER_CASES = {
    "ties": ([1.0, 0.5, 0.5, 2.0], [1, 1, 1, 1]),
    "nan": ([1.0, NAN, 0.5, NAN], [1, 1, 1, 1]),
    "nan_on_a_failure": ([NAN, 2.0, 1.0], [0, 1, 1]),
    "inf": ([INF, -INF, 3.0, -INF], [1, 1, 0, 1]),
    "all_inf": ([INF, INF, INF], [1, 1, 1]),
    "all_failing": ([3.0, 1.0, 2.0, 1.0], [0, 0, 0, 0]),
    "mixed": ([0.1, 5.0, 0.01, 4.0], [0, 1, 0, 1]),
    "one": ([7.0], [0]),
}


@pytest.mark.parametrize("case", list(WINNER_CASES))
def test_pick_winner_matches_jax(case):
    """Any success beats any failure, then the lowest fitness, then the
    lowest rank; NaN as ``jnp.argmin`` takes it (tolerance 0)."""
    fit, ok = WINNER_CASES[case]
    n = len(fit)
    qa = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    fit = np.asarray(fit, np.float32)
    ok = np.asarray(ok, bool)
    got = _pick_winner(torch.from_numpy(qa), torch.from_numpy(fit), torch.from_numpy(ok))
    want = j_pick_winner(None, jnp.asarray(qa), jnp.asarray(fit), jnp.asarray(ok))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _np_inject_lanes(state, qa, fit, tips_row, V):
    """JAX islands.py:157-176 in numpy."""
    genes, grads, sfit, sol_r, sol_fit_r, sol_tips_r = [np.array(x) for x in state]
    odd = (np.arange(genes.shape[1]) % 2) == 1
    qa_col = qa[:, None].astype(genes.dtype)
    genes[V:2 * V] = np.where(odd[None, :], qa_col, genes[V:2 * V])
    grads[V:2 * V] = np.where(odd[None, :], 0.0, grads[V:2 * V])
    better = fit < sol_fit_r[0]
    sol_r = np.where(better[None, :], qa_col, sol_r)
    sol_fit_r = np.where(better[None, :], fit, sol_fit_r)
    sol_tips_r = np.where(better[None, :], tips_row[:, None].astype(sol_tips_r.dtype),
                          sol_tips_r)
    return genes, grads, sfit, sol_r, sol_fit_r, sol_tips_r


@pytest.mark.parametrize("V,T,M", [(7, 1, 64), (17, 2, 30)])
def test_inject_lanes_matches_jax(V, T, M):
    """Random lane state (4 parents' genes, M lanes, species fastest): the
    migrant on the odd (species-1) lanes' second parent, incumbents where
    it is better (tolerance 0)."""
    rng = np.random.default_rng(V)
    f32 = np.float32
    state = (rng.normal(size=(4 * V, M)).astype(f32), rng.normal(size=(4 * V, M)).astype(f32),
             rng.uniform(size=(1, M)).astype(f32), rng.normal(size=(V, M)).astype(f32),
             rng.uniform(size=(1, M)).astype(f32), rng.normal(size=(7 * T, M)).astype(f32))
    qa = rng.normal(size=V).astype(f32)
    fit = np.float32(0.5)
    tips_row = rng.normal(size=7 * T).astype(f32)
    got = _inject_lanes(tuple(torch.from_numpy(x) for x in state), torch.from_numpy(qa),
                        torch.tensor(fit), torch.from_numpy(tips_row), V)
    want = _np_inject_lanes(state, qa, fit, tips_row, V)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the migrant reached exactly the odd lanes' second parent
    assert np.array_equal(got[0][V:2 * V, 1::2].numpy(), np.repeat(qa[:, None], M // 2, 1))
    assert np.array_equal(got[0][V:2 * V, 0::2].numpy(), state[0][V:2 * V, 0::2])


@pytest.fixture(scope="module")
def world_one_rows():
    rows = parallel_check.world_one("cpu", B=8, queries=2, max_steps=4, query_steps=4)
    return {(r["row"], r.get("migrate")): r for r in rows}


def test_world_one_batch_sharded_is_solve_batch(world_one_rows):
    assert world_one_rows[("batch_sharded", None)]["bitwise_solve_batch"]
    assert not dist.is_initialized()


def test_world_one_fused_island_sharded_is_the_single_query(world_one_rows):
    row = world_one_rows[("island_sharded_fused", False)]
    assert row["bitwise_single_query"] and row["queries"] == 2
    assert np.isfinite(world_one_rows[("island_sharded_fused", True)]["ms_per_query"])


def test_world_one_island_path_sharded_is_solve(world_one_rows):
    assert world_one_rows[("island_sharded_island_path", None)]["bitwise_single_query"]


def test_world_two_gloo():
    """Two spawned ranks: the batch halves bitwise, migration the same on
    both ranks and below the seed's fitness."""
    rows = parallel_check.world_two("cpu", B=8, max_steps=4, timeout_s=120)
    assert rows[0]["bitwise_halves_solve_batch"]
    assert rows[1]["same_on_both_ranks"] and rows[1]["fitness"] < rows[1]["seed_fitness"]
    assert not dist.is_initialized()


@pytest.fixture()
def group():
    initialize_distributed(parallel_check.free_address(), 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def test_make_pod_mesh_helpers(group):
    mesh = make_pod_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == 1
    mesh2 = make_pod_mesh(("data", "islands"), (1, 1), device="cpu")
    assert mesh2.size(0) == 1 and mesh2.size(1) == 1
    assert default_mesh("islands", device="cpu").mesh_dim_names == ("islands",)
    with pytest.raises(ValueError):
        make_pod_mesh(("data",), (7,), device="cpu")
    with pytest.raises(ValueError):
        make_pod_mesh(("data", "islands"), device="cpu")
    assert local_batch_slice(64, 1, process_index=0) == slice(0, 64)
    assert local_batch_slice(64, 1) == slice(0, 64)
    with pytest.raises(ValueError):
        local_batch_slice(63, 2)


def test_helpers_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_pod_mesh(device="cpu")
    # JAX arithmetic: rows per process, offset by the index asked for
    assert local_batch_slice(64, 8, process_index=0) == slice(0, 64)
    assert local_batch_slice(64, 8, process_index=1) == slice(64, 128)
    with pytest.raises(ValueError):
        initialize_distributed("127.0.0.1:1", device="cpu")
    assert inspect.signature(initialize_distributed).parameters["device"].default == "cuda"
    assert inspect.signature(make_pod_mesh).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            initialize_distributed("127.0.0.1:1", 1, 0)


class _TwoSlots:
    """A stand-in mesh axis of two ranks (the divisibility check raises
    before any collective)."""
    mesh_dim_names = ("data",)

    def size(self, dim):
        return 2

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_batch_not_divisible_raises():
    m = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    s = IKSolver(m, [G.PoseGoal(link=TIP)], SolverConfig(max_steps=4, dtwist=1e-3))
    data = tree_map(lambda x: x.expand((3,) + x.shape), s.make_data(m.neutral_q()))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_batch_solve(s, _TwoSlots())(torch.zeros((3, 2), dtype=torch.int64), data)
