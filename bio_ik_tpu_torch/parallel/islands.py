"""Multi-card island parallelism over ``torch.distributed``.

Port of :mod:`bio_ik_tpu.parallel.islands` (reference: the thread-racing
executor, src/ik_parallel.h:43-277 — N pthreads parked on a barrier,
sharing ``finished``/``canceled`` flags).  One process per card, SPMD:
every rank of the mesh axis's group calls the returned function with the
same arguments.  Each rank runs the single-card solve on its own islands,
and the winner is chosen by an all-gather reduction over the axis — the
collective analog of the reference's winner scan (ik_parallel.h:220-261),
made identically on every rank, so every rank returns the same result.

Two sharding modes:
  * :func:`make_sharded_island_solve` — ONE query, islands split across
    ranks (latency mode; the analog of the reference's 4-thread race),
    optionally with elite migration between chunks;
  * :func:`make_sharded_batch_solve` — B queries sharded across ranks,
    each rank racing its local islands per query (throughput mode; no
    reference analog), the shards gathered on every rank.

Collectives: NCCL needs CUDA tensors of one shape and dtype on every rank;
flags travel as ``uint8``.  A gloo group (the CPU, or several ranks
sharing one card, where NCCL refuses a duplicate GPU) gathers host copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..api import IKResult
from ..engine import FusedBio2Engine, fold_in
from ..interop import tree_map
from .distributed import make_pod_mesh

__all__ = ["make_sharded_island_solve", "make_sharded_batch_solve", "default_mesh"]


def default_mesh(axis: str = "islands", device="cuda"):
    """A 1-D mesh named ``axis`` over every process of the default group."""
    return make_pod_mesh((axis,), device=device)


def _axis(mesh, axis: str):
    """(group, size, this rank's index) of the mesh dimension ``axis``."""
    dim = list(mesh.mesh_dim_names).index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``(n,) + x.shape``: every rank's ``x`` in the group's rank order,
    on ``x``'s device and in its dtype."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    wire = wire.contiguous()
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=group)
    return torch.stack(out).to(device=x.device, dtype=x.dtype)


def _argbest(key, ok):
    """Index of the winner among stacked candidates (reference order,
    ik_parallel.h:220-261): any success beats any failure, then the lowest
    ``key``, then the lowest index; a NaN key wins as ``jnp.argmin`` picks
    it (the first NaN)."""
    k = torch.where(ok == ok.any(), key, torch.full_like(key, float("inf")))
    nan = k.isnan()
    return torch.where(nan.any(), nan.to(torch.uint8).argmax(), k.argmin())


def _pick_winner(qa, fit, ok):
    """Global winner among per-rank winners stacked on axis 0: ``(qa, fit,
    ok)`` of the candidate :func:`_argbest` picks by fitness."""
    i = _argbest(fit, ok)
    return qa[i], fit[i], ok[i]


def _global_best(best, group, n):
    """The global winner of per-rank ``best = (qa, fit, ok, rank)`` (leaves
    led by one scenario), by the ranking key, identically on every rank."""
    qa, fit, ok, rank = best
    qa_g = _gather(qa, group, n).reshape(-1, qa.shape[-1])
    fit_g = _gather(fit, group, n).reshape(-1)
    ok_g = _gather(ok, group, n).reshape(-1)
    rank_g = _gather(rank, group, n).reshape(-1)
    i = _argbest(rank_g, ok_g)
    return qa_g[i], fit_g[i], ok_g[i], rank_g[i]


def _inject_lanes(state, qa, fit, tips_row, V: int):
    """Lane-layout analog of ``Bio2Solver.inject`` (JAX islands.py:157-176):
    the migrant ``qa (V,)`` replaces the second parent (gene rows
    ``V:2V``, gradients zeroed) on the species-1 lanes — the odd lanes,
    species being the fastest lane axis — and becomes each lane's
    incumbent (with its fitness and exact-FK ``tips_row (7T,)``) where it
    is better."""
    genes, grads, sfit, sol_r, sol_fit_r, sol_tips_r = state
    odd = (torch.arange(genes.shape[1], device=genes.device) % 2) == 1
    qa_col = qa[:, None].to(genes.dtype)
    genes = torch.cat([genes[:V], torch.where(odd[None, :], qa_col, genes[V:2 * V]),
                       genes[2 * V:]])
    grads = torch.cat([grads[:V], torch.where(odd[None, :], 0.0, grads[V:2 * V]),
                       grads[2 * V:]])
    better = fit < sol_fit_r[0]
    sol_r = torch.where(better[None, :], qa_col, sol_r)
    sol_fit_r = torch.where(better[None, :], fit, sol_fit_r)
    sol_tips_r = torch.where(better[None, :], tips_row[:, None].to(sol_tips_r.dtype),
                             sol_tips_r)
    return genes, grads, sfit, sol_r, sol_fit_r, sol_tips_r


def make_sharded_island_solve(iksolver, mesh, axis: str = "islands",
                              migrate: bool = False):
    """Latency mode: one query, each of the ``axis`` ranks running the
    solver's full island count; the global winner by all-gather.

    Rank r solves with key ``fold_in(key, r)``.  With ``migrate=True`` the
    ranks' running bests are all-gathered after each chunk and the global
    best is injected into every local island (``Solver.inject``) — elite
    migration, the island-model extension of SURVEY §5.8 (the reference's
    islands exchange nothing until the end, ik_parallel.h:94-97).

    When the solver has a fused megastep engine (bio2 family on a
    FIXED/REVOLUTE/PRISMATIC chain), each rank runs the engine's kernel
    pipeline on its lanes; migration then injects the global best into the
    species-1 second-parent gene rows of every lane and updates each
    lane's incumbent where better.

    Returns ``solve(key, data) -> IKResult``: ``key`` two 32-bit words,
    ``data`` one query's :meth:`IKSolver.make_data` dict, the same on
    every rank; the result is the same on every rank.
    """
    group, n, r = _axis(mesh, axis)
    engine = iksolver.engine
    if engine is not None and engine.fullstep:
        return _make_sharded_island_solve_fused(iksolver, group, n, r, migrate)
    I = iksolver.islands

    def solve(key, data):
        keys = fold_in(iksolver._key(key)[None], r)
        data_b = tree_map(lambda x: x[None], data)
        state, best, data_r = iksolver._init_islands(keys, data_b)
        for _ in range(iksolver.nchecks):
            state, best = iksolver._chunk(state, best, data_b, data_r)
            if migrate:
                qa, fit, ok, rank = _global_best(best, group, n)
                state = iksolver.solver.inject(
                    state, qa.expand(I, qa.shape[-1]), fit.expand(I))
                best = FusedBio2Engine._merge(
                    best, (qa[None], fit[None], ok[None], rank[None]))
        res = iksolver._result(best, data_b)
        # gather the per-rank winners and reduce identically everywhere;
        # q is the winner's qa scattered into the seed (as _result makes it)
        qa, fit, ok = _pick_winner(*(_gather(x[0], group, n)
                                     for x in (res.qa, res.fitness, res.success)))
        return IKResult(q=iksolver.ctx.qfull(data["seed_full"], qa), success=ok,
                        fitness=fit, qa=qa)

    return solve


def _make_sharded_island_solve_fused(iksolver, group, n, r, migrate):
    """Fused-engine island sharding (see :func:`make_sharded_island_solve`):
    per chunk one megastep launch and the lane winner on each rank."""
    engine, ctx = iksolver.engine, iksolver.ctx
    V = engine.sp.V

    def solve(key, data):
        keys = fold_in(iksolver._key(key)[None], r)
        data_b = tree_map(lambda x: x[None], data)
        state, consts, salt, best = engine._mega_prep(keys, data_b)
        for c in range(engine.nchecks):
            state, best = engine._mega_chunk(c, salt, state, consts, best, data_b)
            if migrate:
                qa, fit, ok, rank = _global_best(best, group, n)
                tipf = ctx.tips_frame(data_b["seed_full"], qa[None])
                tips_row = torch.cat([tipf.pos, tipf.quat], -1).reshape(-1)
                state = _inject_lanes(state, qa, fit, tips_row, V)
                best = engine._merge(best, (qa[None], fit[None], ok[None], rank[None]))
        qa, fit, ok, _ = _global_best(best, group, n)
        qa = iksolver._rewrap(qa, data["seed_active"])
        return IKResult(q=ctx.qfull(data["seed_full"], qa), success=ok, fitness=fit,
                        qa=qa)

    return solve


def make_sharded_batch_solve(iksolver, mesh, axis: str = "data"):
    """Throughput mode: the scenario batch sharded over the ``axis`` ranks;
    rank r solves rows ``[r·B/n, (r+1)·B/n)`` — on the fused engine where
    the solver has one (the multi-card scaling path of the headline
    benchmark), else on the island path — and the shards are all-gathered,
    so every rank holds the whole result.  Every query's islands stay on
    one rank.

    Returns ``solve(keys (B, 2), data) -> IKResult`` with B divisible by the
    axis size; every leaf of ``data`` carries the leading B axis.
    """
    group, n, r = _axis(mesh, axis)
    run = (iksolver.engine._solve_batch if iksolver.engine is not None
           else iksolver._solve_batch)

    def solve(keys, data):
        B = keys.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by mesh size {n}")
        rows = slice(r * (B // n), (r + 1) * (B // n))
        res = run(keys[rows], tree_map(lambda x: x[rows], data))
        return IKResult(*(_gather(x, group, n).reshape((B,) + x.shape[1:])
                          for x in res))

    return solve
