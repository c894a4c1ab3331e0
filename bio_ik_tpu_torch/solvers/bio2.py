"""bio2 memetic-evolutionary solver family (the reference default).

Port of :mod:`bio_ik_tpu.solvers.bio2` (reference: IKEvolution2,
src/ik_evolution_2.cpp:45-658; modes ``bio2``, ``bio2_memetic`` and
``bio2_memetic_l`` at :652-654, and ``bio2_memetic_lbfgs`` at :656-658), the
unfused solver of the island path.
The fused engine (``engine.py``) reads :func:`quat_gene_slices` from here.

Per island per step (reference step(), ik_evolution_2.cpp:328-646), two
species each: linearize the tip frames at the species' best individual;
8 generations (16 without the memetic phase) of reproduce → pre-select →
approximate fitness → keep the best 2; 8 iterations of gradient + 3-point
line search on the approximate fitness (or, in ``bio2_memetic_lbfgs``, 8
L-BFGS updates, ``solvers/lbfgs.py``); exact fitness, species sort,
wipeout of a stagnant non-best species, incumbent update.

Every tensor carries a leading row axis R (scenario × island) and the
species axis S after it; a step is one pass of batched tensor code over
all rows at once.  Randomness comes from one ``torch.Generator`` per solve
(:meth:`Bio2Solver.draw_step` draws a whole step's worth in five calls);
``step``, ``_reproduce`` and ``_memetic`` take the draws as arguments, so
tests can feed them the JAX package's own.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..kinematics.approx import apply_deltas
from ..math.quat import quat_normalize_fast
from ..robot.urdf import FLOATING
from ..graphs import Replay
from .base import Solver, SolverContext, register_solver
from .lbfgs import QuasiNewton, line_iteration, value_and_grad

__all__ = ["Bio2Solver", "Bio2State", "Bio2Draws", "quat_gene_slices"]

_SPECIES = 2            # reference: species.resize(2), ik_evolution_2.cpp:141
_PARENTS = 2            # population_size = 2, :137
_CHILDREN = 16          # child_count = 16, :138
_MEMETIC_ITERS = 8      # :453
_WIPEOUT_P = 0.1        # :622


def quat_gene_slices(model, active_vars: Sequence[int]) -> List[int]:
    """Start slots, in the active-gene vector, of the quaternion blocks of
    active floating joints — renormalized after every mutation (reference:
    ik_evolution_2.cpp:117-126, :320-324).  A block counts only when its
    four variables are active and contiguous in the active set, the rule
    of ``Bio2Solver.__init__`` (bio_ik_tpu/solvers/bio2.py:69-81)."""
    active = list(active_vars)
    out = []
    for li in range(model.nlinks):
        if model.jtype[li] == FLOATING and model.vstart[li] >= 0:
            qv = int(model.vstart[li]) + 3
            if qv in active:
                s = active.index(qv)
                if active[s:s + 4] == [qv, qv + 1, qv + 2, qv + 3]:
                    out.append(s)
    return out


class Bio2State(NamedTuple):
    generator: torch.Generator
    genes: torch.Tensor             # (R, S, P, V)
    grads: torch.Tensor             # (R, S, P, V) momentum "gradients"
    species_fitness: torch.Tensor   # (R, S) exact fitness of each species' best
    solution: torch.Tensor          # (R, V) incumbent
    solution_fitness: torch.Tensor  # (R,)


class Bio2Draws(NamedTuple):
    """One step's randomness (JAX bio2.py:114-123, :146, :307-308)."""

    rate_exp: torch.Tensor          # (gens, R, S, C) integers in [0, 16)
    noise: torch.Tensor             # (gens, R, S, C, V) standard normals
    keep: Optional[torch.Tensor]    # (gens, R, S) integers in [1, C); secondary only
    wipe_u: torch.Tensor            # (R, S) uniforms: the wipeout coin
    wipe_g: torch.Tensor            # (R, S, V) uniforms: the restart genes


def _approx_fitness(p, x, x0, tips0, deltas, data, combined=False):
    """The fitness of genes ``x`` on the linearization ``tips0 + deltas·(x −
    x0)`` at ``x0``: primary, or with ``combined`` primary + secondary."""
    phen = tips0 + torch.einsum("...tvd,...v->...td", deltas, x - x0)
    f = p.fitness(phen, x, data)
    return f + p.fitness_secondary(x, data) if combined and p.has_secondary else f


def _lead(data, k: int):
    """``data`` with ``k`` unit axes after its row axis (views)."""
    if isinstance(data, dict):
        return {n: _lead(v, k) for n, v in data.items()}
    if isinstance(data, list):
        return [_lead(v, k) for v in data]
    return data.reshape(data.shape[:1] + (1,) * k + data.shape[1:])


class Bio2Solver(Solver):
    """``memetic`` ∈ {'', 'q', 'l', 'o'} selects bio2 / bio2_memetic /
    bio2_memetic_l / bio2_memetic_lbfgs (reference template parameter,
    ik_evolution_2.cpp:45)."""

    default_islands = 4  # reference: concurrency(), ik_evolution_2.cpp:649

    def __init__(self, ctx: SolverContext, config, memetic="q"):
        super().__init__(ctx, config)
        if memetic not in ("", "q", "l", "o"):
            raise ValueError(f"memetic must be '', 'q', 'l' or 'o', got {memetic!r}")
        self.memetic = memetic
        self.generations = 8 if memetic else 16  # reference :349-350
        self.quat_slices = quat_gene_slices(ctx.problem.model,
                                            ctx.problem.active_vars)
        p = ctx.problem
        child = torch.arange(2, 2 + _CHILDREN, device=p.device)  # reference child_index
        dt = p.amin.dtype
        # parent-gradient mix (reference :294) and gradient factor per child
        self._fmix = torch.where(child % 2 == 0, 0.2, 0.0).to(dt)[:, None]
        self._fmix1 = 1 - self._fmix
        self._gfac = (child % 3).to(dt)[:, None]
        self._lbfgs = QuasiNewton(memory=10)

        # the L-BFGS objective's value and gradient at the clipped genes on
        # data, over the linearization (x0, tips0, deltas), and the line
        # search's iteration with it, each replayed from a CUDA graph on the
        # card
        def vg(x, x0, tips0, deltas, data):
            return value_and_grad(lambda y: _approx_fitness(
                p, ctx.clip_tied(y), x0, tips0, deltas, data, combined=True), x)

        self._lbfgs_vg = Replay(vg)
        self._lbfgs_line = Replay(line_iteration(vg, self._lbfgs.max_steps))

    # ------------------------------------------------------------------
    def init(self, generator, data, randomize=None):
        """All islands start from the seed (reference `if(1)` branch,
        ik_evolution_2.cpp:155-166): ``randomize`` is ignored, as in JAX
        bio2.py:89."""
        p = self.ctx.problem
        seed = data["seed_active"].to(p.amin.dtype)               # (R, V)
        R, V = seed.shape
        genes = seed[:, None, None, :].expand(R, _SPECIES, _PARENTS, V).clone()
        return Bio2State(
            generator=generator, genes=genes, grads=torch.zeros_like(genes),
            species_fitness=torch.full((R, _SPECIES), float("inf"), dtype=seed.dtype,
                                       device=seed.device),
            solution=seed.clone(),
            solution_fitness=self.ctx.fitness_exact(seed, data))

    def draw_step(self, generator, R: int) -> Bio2Draws:
        """One step's draws for ``R`` rows from ``generator``."""
        p = self.ctx.problem
        dev, dt = p.amin.device, p.amin.dtype
        g, S, C, V = self.generations, _SPECIES, _CHILDREN, self.ctx.nvars
        rate_exp = torch.randint(0, 16, (g, R, S, C), generator=generator, device=dev)
        noise = torch.randn((g, R, S, C, V), generator=generator, dtype=dt, device=dev)
        keep = (torch.randint(1, C, (g, R, S), generator=generator, device=dev)
                if p.has_secondary else None)
        wipe_u = torch.rand((R, S), generator=generator, dtype=dt, device=dev)
        wipe_g = torch.rand((R, S, V), generator=generator, dtype=dt, device=dev)
        return Bio2Draws(rate_exp, noise, keep, wipe_u, wipe_g)

    # ------------------------------------------------------------------
    def _reproduce(self, genes, grads, x0, tips0, deltas, data, rate_exp, noise,
                   keep=None):
        """One generation: 16 children from parent 0, pre-selection by
        secondary fitness, approximate primary fitness, the best 2 of
        {parents, children} (reference: ik_evolution_2.cpp:242-431).

        ``genes/grads (..., P, V)``, the linearization point ``x0 (..., V)``
        with ``tips0 (..., T, 7)`` and ``deltas (..., T, V, 7)``; ``data``
        broadcasts against ``(..., 2 + C)``; draws ``rate_exp (..., C)``,
        ``noise (..., C, V)``, ``keep (...)``.  Returns ``(genes, grads)``."""
        p = self.ctx.problem
        # mutation_rate = 2^k / 2^23, k ∈ [0,16) (reference :265)
        mutation_rate = torch.exp2(rate_exp.to(genes.dtype) - 23.0)
        parent_genes = genes[..., 0:1, :]
        parent_grad = grads[..., 0:1, :] * self._fmix1 + grads[..., 1:2, :] * self._fmix
        gene = parent_genes + noise * (mutation_rate[..., None] * p.aspan)
        gene = gene + parent_grad * self._gfac
        gene = torch.clamp(gene, p.aclip_min, p.aclip_max)
        child_grads = parent_grad * 0.7 + (gene - parent_genes) * 0.3  # mix(:299)
        for s in self.quat_slices:
            gene[..., s:s + 4] = quat_normalize_fast(gene[..., s:s + 4])

        # candidate pool: parents first (kept alive, reference :381-388)
        pool_genes = torch.cat([genes, gene], dim=-2)            # (..., 2+C, V)
        pool_grads = torch.cat([grads, child_grads], dim=-2)

        # approximate phenotypes from the linearization point (reference
        # :391-407) and the primary fitness
        phen = apply_deltas(tips0, deltas, pool_genes - x0[..., None, :])
        fit = p.fitness(phen, pool_genes, data)                  # (..., 2+C)
        if p.has_secondary:
            # pre-selection: the children ranked by secondary fitness, a
            # random count of the best kept (reference :366-378)
            fsec = p.fitness_secondary(gene, data)
            rank = torch.argsort(torch.argsort(fsec, dim=-1, stable=True), dim=-1,
                                 stable=True)
            alive = torch.cat([torch.ones_like(rank[..., :_PARENTS], dtype=torch.bool),
                               rank < keep[..., None]], dim=-1)
            fit = torch.where(alive, fit, float("inf"))

        # the best 2, the lower index first on ties (jax.lax.top_k)
        top = torch.argsort(fit, dim=-1, stable=True)[..., :_PARENTS, None]
        V = genes.shape[-1]
        idx = top.expand(top.shape[:-1] + (V,))
        return pool_genes.gather(-2, idx), pool_grads.gather(-2, idx)

    # ------------------------------------------------------------------
    def _approx_grad(self, x, x0, tips0, deltas, data):
        """Primary and combined approximate fitness at ``x (..., V)`` and the
        combined one's gradient (JAX: ``jax.value_and_grad`` of
        ``combined_at``, bio2.py:180-188): autograd of the sum over rows,
        which are independent.  Returns ``(f_primary, f_combined, grad)``."""
        p = self.ctx.problem
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            fp = _approx_fitness(p, x, x0, tips0, deltas, data)
            fa = fp + p.fitness_secondary(x, data) if p.has_secondary else fp
            (grad,) = torch.autograd.grad(fa.sum(), x)
        return fp.detach(), fa.detach(), grad

    def _memetic(self, genes0, x0, tips0, deltas, data):
        """Gradient descent on the approximate fitness (reference:
        ik_evolution_2.cpp:439-569): the exact gradient of the combined
        approximate fitness (autograd; the reference's forward differences
        at dp = 1e-7 do not resolve in float32), its L1 normalization to a
        probe length h, and the reference's 3-point line search — a
        quadratic ('q', :498-516) or linear ('l', :545-556) step — while
        the primary fitness improves.  ``genes0 (..., V)``; ``data``
        broadcasts against ``(...)`` and ``(..., 2)``."""
        ctx, p = self.ctx, self.ctx.problem
        if self.memetic == "o":
            return self._memetic_lbfgs(genes0, x0, tips0, deltas, data)
        h = 1e-3
        # the linearization with a unit axis for the two probes of a row
        lin2 = (x0[..., None, :], tips0[..., None, :, :], deltas[..., None, :, :, :])
        genes = genes0
        done = torch.zeros(genes0.shape[:-1], dtype=torch.bool, device=genes0.device)
        for _ in range(_MEMETIC_ITERS):
            f2p, f2, grad = self._approx_grad(genes, x0, tips0, deltas, data)
            # L1 normalization to probe length h (reference :477-482)
            g = grad * (h / (torch.sum(torch.abs(grad), dim=-1, keepdim=True) + 1e-12))
            # 3-point line probe (reference :485-495), both sides at once
            f13 = _approx_fitness(p, torch.stack([genes - g, genes + g], dim=-2), *lin2,
                                  _lead(data, 1), combined=True)
            f1, f3 = f13[..., 0], f13[..., 1]
            if self.memetic == "q":
                v1, v2 = f2 - f1, f3 - f2
                step = ((v1 + v2) * 0.5) / (v1 - v2)
                step = torch.where(torch.isfinite(step), step, 0.0)
                cand = ctx.clip(genes + g * step[..., None])
            else:
                step = f2 / ((f3 - f1) * 0.5)
                step = torch.where(torch.isfinite(step), step, 0.0)
                cand = ctx.clip(genes - g * step[..., None])
            f4p = _approx_fitness(p, cand, x0, tips0, deltas, data)
            accept = (f4p < f2p) & ~done
            genes = torch.where(accept[..., None], cand, genes)
            # break on the first non-improvement (:535-537); the loop ends
            # once every row has broken (one host read per iteration)
            done = done | ~accept
            if bool(done.all()):
                break
        return genes

    def _memetic_lbfgs(self, genes0, x0, tips0, deltas, data):
        """The L-BFGS memetic phase (JAX bio2.py:190-219; reference:
        bio2_memetic_lbfgs, ik_evolution_2.cpp:571-600): ``_MEMETIC_ITERS``
        L-BFGS updates (memory 10, the zoom line search) on the combined
        approximate fitness at the clipped genes, then the clip, the check on
        a finite result and keep-if-better."""
        ctx, p = self.ctx, self.ctx.problem
        opt = self._lbfgs
        x, st = genes0, opt.init(genes0)
        for _ in range(_MEMETIC_ITERS):
            x, st = opt.update(self._lbfgs_vg, x, st, (x0, tips0, deltas, data),
                               self._lbfgs_line)
        x = ctx.clip(x)
        x = torch.where(torch.isfinite(x).all(dim=-1, keepdim=True), x, genes0)
        better = (_approx_fitness(p, x, x0, tips0, deltas, data, combined=True)
                  < _approx_fitness(p, genes0, x0, tips0, deltas, data, combined=True))
        return torch.where(better[..., None], x, genes0)

    # ------------------------------------------------------------------
    def step(self, st: Bio2State, data, draws: Optional[Bio2Draws] = None) -> Bio2State:
        ctx, p = self.ctx, self.ctx.problem
        R = st.genes.shape[0]
        if draws is None:
            draws = self.draw_step(st.generator, R)
        d1, d2 = _lead(data, 1), _lead(data, 2)
        genes, grads = st.genes, st.grads
        # linearization at each species' best (reference :341-346)
        x0 = genes[:, :, 0]                                         # (R, S, V)
        tips0, deltas = ctx.linearize(ctx.qfull(d1["seed_full"], x0))
        for i in range(self.generations):
            genes, grads = self._reproduce(
                genes, grads, x0, tips0, deltas, d2, draws.rate_exp[i],
                draws.noise[i], None if draws.keep is None else draws.keep[i])
        if self.memetic:
            best = self._memetic(genes[:, :, 0], x0, tips0, deltas, d1)
            genes = torch.cat([best[:, :, None], genes[:, :, 1:]], dim=2)
        # exact species fitness (reference :608-614)
        sfit = ctx.fitness_exact(genes[:, :, 0], d1)                # (R, S)
        return self._bookkeep(st, genes, grads, sfit, draws.wipe_u, draws.wipe_g)

    def _bookkeep(self, st, genes, grads, sfit, wipe_u, wipe_g):
        """Species sort, wipeout of the stagnant non-best species, incumbent
        update (reference :612-644)."""
        p = self.ctx.problem
        improved = sfit != st.species_fitness                       # (:612)
        order = torch.argsort(sfit, dim=-1, stable=True)            # (:617)
        sfit, improved = sfit.gather(1, order), improved.gather(1, order)
        o4 = order[:, :, None, None].expand(genes.shape)
        genes, grads = genes.gather(1, o4), grads.gather(1, o4)
        # wipeout (reference :620-637): species 0 is never wiped
        non_best = torch.arange(_SPECIES, device=sfit.device) > 0
        wipe = ((wipe_u < _WIPEOUT_P) | ~improved) & non_best
        rand_genes = p.amin + wipe_g * (p.amax - p.amin)           # (R, S, V)
        new_first = torch.where(wipe[..., None], rand_genes, genes[:, :, 0])
        genes = torch.where(wipe[..., None, None], new_first[:, :, None].expand(genes.shape),
                            genes)
        grads = torch.where(wipe[..., None, None], 0.0, grads)
        # incumbent update (reference :640-644)
        better = sfit[:, 0] < st.solution_fitness
        return Bio2State(
            generator=st.generator, genes=genes, grads=grads, species_fitness=sfit,
            solution=torch.where(better[:, None], genes[:, 0, 0], st.solution),
            solution_fitness=torch.where(better, sfit[:, 0], st.solution_fitness))

    def solution(self, st: Bio2State, data):
        return st.solution, st.solution_fitness

    def inject(self, st: Bio2State, qa, fitness):
        """Absorb a migrant: it replaces the last species' second parent
        (each species keeps its own best) and the incumbent where better
        (see Solver.inject)."""
        genes = st.genes.clone()
        genes[:, _SPECIES - 1, 1] = qa.to(genes.dtype)
        better = fitness < st.solution_fitness
        return st._replace(
            genes=genes,
            solution=torch.where(better[:, None], qa, st.solution),
            solution_fitness=torch.minimum(fitness, st.solution_fitness))


register_solver("bio2")(lambda ctx, config: Bio2Solver(ctx, config, memetic=""))
register_solver("bio2_memetic")(lambda ctx, config: Bio2Solver(ctx, config, memetic="q"))
register_solver("bio2_memetic_l")(lambda ctx, config: Bio2Solver(ctx, config, memetic="l"))
register_solver("bio2_memetic_lbfgs")(
    lambda ctx, config: Bio2Solver(ctx, config, memetic="o"))
