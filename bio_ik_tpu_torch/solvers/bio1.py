"""bio1 evolutionary solver — the original Unity BioIK.

Port of :mod:`bio_ik_tpu.solvers.bio1` (reference: IKEvolution1,
src/ik_evolution_1.cpp:40-561, registered as ``bio1`` at :558).  Per row
(scenario × island) and step (reference evolve(), :501-548):

  * the elites improve by a greedy per-variable ``exploit`` with heuristic
    step sizes (:387-432): a Python loop over the variables, each one exact
    FK of the elites' two probes;
  * the other individuals are children of parents drawn with the
    triangular rank distribution from a pool that shrinks as children beat
    their parents (:143-149, :518-533), with extinction-scaled mutation
    (:153-158, :303-312) and gene mixing toward the parents' mean and a
    prototype (:354-385): a loop over the children, each op over the rows;
  * sort, extinction factors, the solution update, and a wipeout restart
    when no single-variable probe of the best improves it (:277-301,
    :536-547).

Every fitness is exact FK (bio1 predates the mutation approximator).  The
triangular parent pick is a Gumbel-max draw over the logits
``log(na − rank)`` (``P(rank j) ∝ na − j`` among the ``na`` pool members,
the distribution of the reference's rejection sampler, utils.h:348-367),
as ``jax.random.categorical`` draws it in the JAX package.

The ``linear_fitness`` mode (:253-275) mixes each pose-type goal's position
and rotation distance with a random weight (0.5 where "balanced"), with the
angular scale ``sqrt(chain_length·‖p_goal‖)/π`` (:161-165); other goal kinds
do not contribute in that mode.  The rotation distance is
:func:`quat_angle_atan2`, where the JAX package takes the arccos of the
quaternions' dot (the reference's tf2 angleShortestPath, in double): in
float32 the clamped arccos is blind to rotations below ~1 mrad, the
acceptance test's ``dtwist``, wherever FK's rounding leaves the quaternions'
norms above 1 — on an H100 the linear mode then solved 0.066 of Table B's
PR2 targets, on a CPU 0.297, and with the atan2 form 0.660 and 0.648
(``tools/bio1_devices.py``; PERF.md).  Away from small angles the two agree
to rounding.

Randomness comes from one ``torch.Generator`` per solve
(:meth:`Bio1Solver.draw_step` draws a step's worth); ``step`` and the
helpers take the draws as arguments, so tests can feed the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graphs import Replay, const
from ..math.frame import Frame
from ..math.quat import quat_angle_atan2
from .base import Solver, SolverContext, register_solver
from .bio2 import _lead

__all__ = ["Bio1Solver", "Bio1State", "Bio1Draws"]


class Bio1State(NamedTuple):
    generator: torch.Generator
    genes: torch.Tensor       # (R, N, V) sorted by fitness, ascending
    grads: torch.Tensor       # (R, N, V)
    fitness: torch.Tensor     # (R, N)
    extinction: torch.Tensor  # (R, N)
    solution: torch.Tensor    # (R, V)


class Bio1Draws(NamedTuple):
    """One step's randomness (JAX bio1.py:296-405).  C = N − E children, G
    pose-type goals; the ``*_w`` mixing weights exist only with
    ``linear_fitness``."""

    exploit: torch.Tensor         # (V, 3, R, E) uniforms: inc, dec, gradient mix
    gumbel: torch.Tensor          # (C, 3, R, N) Gumbel noise: parents a, b, prototype
    repro: torch.Tensor           # (C, 9, R, V) uniforms of _reproduce
    child_w: Optional[torch.Tensor]   # (C, R, G)
    reroll_u: torch.Tensor        # (C, R, V) uniforms: the reroll's configuration
    reroll_t: torch.Tensor        # (C, R, V) uniforms: its pull toward mid-range
    reroll_w: Optional[torch.Tensor]  # (C, R, G)
    wipe_up: torch.Tensor         # (R, V) uniforms: the wipeout probes' steps up
    wipe_down: torch.Tensor       # (R, V) and down
    pop_u: torch.Tensor           # (R, N, V) the restart population's rerolls
    pop_t: torch.Tensor           # (R, N, V)
    pop_w: Optional[torch.Tensor]     # (R, N, G)


def _triangular_pick(gumbel, mask):
    """Index ``(R,)`` drawn per row with the reference's triangular parent
    distribution restricted to ``mask (R, N)``: among the ``na`` members (in
    ascending-fitness order) rank ``j`` has weight ``na − j`` (reference:
    linear_int_distribution, utils.h:348-367) — Gumbel-max over ``gumbel
    (R, N)``.  An empty pool gives 0."""
    rank = torch.cumsum(mask, dim=-1) - 1
    na = torch.sum(mask, dim=-1, keepdim=True)
    w = torch.where(mask, (na - rank).to(torch.float32), 0.0)
    logits = torch.where(w > 0, torch.log(w), float("-inf"))
    return torch.argmax(gumbel.to(torch.float32) + logits, dim=-1)


def _take(x, idx):
    """``x[r, idx[r]]`` of ``x (R, N, ...)``."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 1))
    return x.gather(1, i.expand((idx.shape[0], 1) + x.shape[2:]))[:, 0]


class Bio1Solver(Solver):
    default_islands = 4  # reference: concurrency(), ik_evolution_1.cpp:555

    def __init__(self, ctx: SolverContext, config):
        super().__init__(ctx, config)
        self.N = max(config.population_size, 2)
        self.elites = min(config.elite_count, self.N - 1)
        self.no_wipeout = config.no_wipeout
        self.linear_fitness = config.linear_fitness
        self._build_heuristic_tables()
        self._replay = Replay(lambda st, data, draws: tuple(
            self._step(Bio1State(None, *st), data, draws)[1:]))

    # -- HeuristicErrorTree (reference: ik_evolution_1.cpp:50-119) --------
    def _build_heuristic_tables(self):
        ctx = self.ctx
        p = ctx.problem
        model = p.model
        V = ctx.nvars
        active = list(p.active_vars)
        # pose-type goal instances: (group index, instance, tip slot)
        self.pose_goals = [(gi, k, int(grp.tip_slots[k]))
                           for gi, grp in enumerate(p.primary)
                           if grp.goal_type in ("position", "orientation", "pose")
                           for k in range(grp.count)]
        G = len(self.pose_goals)
        tip_idx = [model.link_index[t] for t in p.tip_links]
        influence = np.zeros((V, G))
        chain_len = np.zeros(G)
        chain_len2 = np.zeros((G, V))
        for g, (_, _, slot) in enumerate(self.pose_goals):
            acc = 0.0
            for li in model.ancestors(tip_idx[slot])[::-1]:  # tip → root
                vs, vc = int(model.vstart[li]), int(model.vcount[li])
                if vs >= 0:
                    for v in range(vs, vs + vc):
                        if v in active:
                            i = active.index(v)
                            influence[i, g] = 1.0
                            chain_len2[g, i] = acc
                acc += float(np.linalg.norm(model.origin_pos[li]))
            chain_len[g] = acc
        s = influence.sum(axis=1, keepdims=True)
        influence = np.where(s > 0, influence / np.maximum(s, 1), 0.0)

        def dev(x, dt=p.tdtype):
            return torch.as_tensor(np.asarray(x), device=p.device).to(dt)

        self.influence_t = dev(influence.T)                       # (G, V)
        self.chain_len = dev(chain_len)                           # (G,)
        self.chain_len2 = dev(chain_len2)                         # (G, V)
        av = np.asarray(active)
        self.is_prismatic = dev(model.var_is_prismatic[av], torch.bool)
        self.is_revolute = dev(model.var_is_revolute[av], torch.bool)
        self.slots = dev(np.asarray([s for _, _, s in self.pose_goals], np.int64),
                         torch.int64)

    # -- per-goal frames from problem data --------------------------------
    def _goal_frames(self, data):
        """``(..., G, 3)`` positions and ``(..., G, 4)`` orientations of the
        pose-type goals, identity where a goal does not constrain them
        (reference GoalInfo.frame, problem.cpp:153-176)."""
        pos, quat = [], []
        for gi, k, _ in self.pose_goals:
            gdata = data["primary"][gi]
            lead = gdata["weight_sq"][..., k]
            pos.append(gdata["position"][..., k, :] if "position" in gdata
                       else lead.new_zeros(lead.shape + (3,)))
            quat.append(gdata["orientation"][..., k, :] if "orientation" in gdata
                        else const((0.0, 0.0, 0.0, 1.0), lead.dtype, lead.device).expand(
                            lead.shape + (4,)))
        return torch.stack(pos, dim=-2), torch.stack(quat, dim=-2)

    def _distances(self, tips: Frame, data):
        """Per pose-type goal: position distance and shortest rotation
        angle ``(..., G)``, and the goal positions."""
        gp, gq = self._goal_frames(data)
        tp = tips.pos[..., self.slots, :]
        tq = tips.quat[..., self.slots, :]
        return (torch.linalg.vector_norm(tp - gp, dim=-1),
                quat_angle_atan2(tq, gq), gp)

    def _heuristic_errors(self, tips: Frame, data):
        """Heuristic error per active variable ``(..., V)`` at the tip
        frames ``tips`` (reference: getHeuristicError,
        ik_evolution_1.cpp:171-236)."""
        pos_dist, rot_ang, _ = self._distances(tips, data)
        pd, ra = pos_dist[..., None], rot_ang[..., None]          # (..., G, 1)
        L = self.chain_len2
        has_len = L > 0
        rev = torch.where(has_len, 0.5 * (pd / torch.clamp(L, min=1e-9) + ra), ra)
        pris = torch.where(has_len, 0.5 * (pd + ra * L), pd)
        per_var = torch.where(self.is_revolute, rev,
                              torch.where(self.is_prismatic, pris, 0.0))
        return torch.sum(per_var * self.influence_t, dim=-2)

    # -- fitness ----------------------------------------------------------
    def _fitness(self, genes, data, w=None, tips: Optional[Frame] = None):
        """The standard fitness, or with ``linear_fitness`` the linear mix
        of position and rotation distances (reference: computeFitness,
        ik_evolution_1.cpp:253-275): each goal's weight ``w (..., G)`` where
        given (offspring, rerolls and the initial population: :250, :384,
        :457), else 0.5 ("balanced": the exploit probes, the wipeout check
        and the solution comparisons, :285-291, :317-318, :397-408).
        ``tips``: the exact tip frames of ``genes`` where known."""
        ctx = self.ctx
        if tips is None:
            tips = ctx.tips_frame(data["seed_full"], genes)
        if not self.linear_fitness:
            return ctx.problem.fitness(torch.cat([tips.pos, tips.quat], dim=-1),
                                       genes, data)
        pos_dist, rot_ang, gp = self._distances(tips, data)
        scale = torch.sqrt(self.chain_len * torch.linalg.vector_norm(gp, dim=-1)) / math.pi
        tdist = pos_dist / torch.clamp(scale, min=1e-9)
        if w is None:
            w = 0.5
        return torch.sum(tdist * (1 - w) + rot_ang * w, dim=-1)

    # -- lifecycle --------------------------------------------------------
    def _reroll(self, u, t):
        """Random restarts (reference: reroll, :241-251): uniform in the
        limits (uniforms ``u``), mixed toward mid-range by U(0, 0.1)
        (uniforms ``t``)."""
        p = self.ctx.problem
        t = t * 0.1
        return (p.amin + u * (p.amax - p.amin)) * (1 - t) + p.amid * t

    def _extinctions(self, fitness):
        """Rank-scaled extinction factors of sorted ``fitness (..., N)``
        (reference: computeExtinctions, :303-312):
        ``(fit[i] + min·(i/(n−1) − 1)) / max``."""
        n = fitness.shape[-1]
        fmin, fmax = fitness[..., :1], fitness[..., -1:]
        grading = torch.arange(n, dtype=fitness.dtype, device=fitness.device) / (n - 1)
        return (fitness + fmin * (grading - 1)) / torch.where(fmax != 0, fmax, 1.0)

    def _population_from(self, seed_genes, data, u, t, w):
        """Individual 0 the seed or solution, the others rerolled, sorted
        (reference: init(), :445-471; the initial fitness is the random
        linear mix, computeFitness(genes, false) at :457).  ``seed_genes
        (R, V)``, draws ``u, t (R, N, V)``, ``w (R, N, G)``."""
        genes = torch.cat([seed_genes[:, None], self._reroll(u, t)[:, 1:]], dim=1)
        fit = self._fitness(genes, _lead(data, 1), w)
        order = torch.argsort(fit, dim=-1, stable=True)
        genes, fit = _gather_n(genes, order), fit.gather(1, order)
        return genes, torch.zeros_like(genes), fit, self._extinctions(fit)

    def _uniform(self, generator, shape):
        p = self.ctx.problem
        return torch.rand(shape, generator=generator, dtype=p.tdtype, device=p.device)

    def init(self, generator, data, randomize=None):
        """``randomize`` is ignored, as in JAX bio1.py:253."""
        R, N, V = data["seed_active"].shape[0], self.N, self.ctx.nvars
        seed = data["seed_active"].to(self.ctx.problem.tdtype)
        w = (self._uniform(generator, (R, N, len(self.pose_goals)))
             if self.linear_fitness else None)
        genes, grads, fit, ext = self._population_from(
            seed, data, self._uniform(generator, (R, N, V)),
            self._uniform(generator, (R, N, V)), w)
        return Bio1State(generator=generator, genes=genes, grads=grads, fitness=fit,
                         extinction=ext, solution=seed)

    def draw_step(self, generator, R: int) -> Bio1Draws:
        """One step's draws for ``R`` rows from ``generator``."""
        N, E, V, G = self.N, self.elites, self.ctx.nvars, len(self.pose_goals)
        C = N - E
        u = lambda *shape: self._uniform(generator, shape)  # noqa: E731
        lin = self.linear_fitness
        p = self.ctx.problem
        gumbel = -torch.log(torch.empty((C, 3, R, N), dtype=torch.float32, device=p.device)
                            .exponential_(generator=generator))
        return Bio1Draws(
            exploit=u(V, 3, R, E), gumbel=gumbel, repro=u(C, 9, R, V),
            child_w=u(C, R, G) if lin else None, reroll_u=u(C, R, V),
            reroll_t=u(C, R, V), reroll_w=u(C, R, G) if lin else None,
            wipe_up=u(R, V), wipe_down=u(R, V), pop_u=u(R, N, V), pop_t=u(R, N, V),
            pop_w=u(R, N, G) if lin else None)

    # -- exploit (reference: :387-432) ------------------------------------
    def _exploit(self, genes, grads, data, draws):
        """Greedy per-variable descent of ``genes, grads (R, E, V)``;
        ``data`` broadcasts against ``(R, E)`` and ``(R, E, 2)``; ``draws
        (V, 3, R, E)``.  For each variable in turn, two probes (up and down
        by a random fraction of the heuristic error), both evaluated with
        one exact FK; the better improving probe is taken, and its tip
        frames are the next variable's.  Returns ``(genes, grads, mean
        fitness over the variables)``."""
        ctx, p = self.ctx, self.ctx.problem
        V = ctx.nvars
        d1 = _lead(data, 1)
        genes, grads = genes.clone(), grads.clone()
        tips = ctx.tips_frame(data["seed_full"], genes)                 # (R, E, T)
        f0 = self._fitness(genes, data, tips=tips)
        fsum = torch.zeros_like(f0)
        for i in range(V):
            v0 = genes[..., i]
            he = self._heuristic_errors(tips, data)[..., i]
            lo, hi = p.aclip_min[i], p.aclip_max[i]
            vinc = torch.clamp(v0 + draws[i, 0] * he, lo, hi)
            vdec = torch.clamp(v0 - draws[i, 1] * he, lo, hi)
            probes = genes[..., None, :].repeat_interleave(2, dim=-2)   # (R, E, 2, V)
            probes[..., 0, i], probes[..., 1, i] = vinc, vdec
            ptips = ctx.tips_frame(d1["seed_full"], probes)
            fp = self._fitness(probes, d1, tips=ptips)
            finc, fdec = fp[..., 0], fp[..., 1]
            take_inc = (finc < f0) & (finc <= fdec)
            take_dec = (fdec < f0) & (fdec <= finc) & ~take_inc
            newv = torch.where(take_inc, vinc, torch.where(take_dec, vdec, v0))
            grads[..., i] = torch.where(take_inc | take_dec,
                                        v0 * draws[i, 2] + newv - v0, grads[..., i])
            f0 = torch.where(take_inc, finc, torch.where(take_dec, fdec, f0))
            fsum = fsum + f0
            genes[..., i] = newv
            ti, td = take_inc[..., None, None], take_dec[..., None, None]
            tips = Frame(*(torch.where(ti, x[..., 0, :, :], torch.where(td, x[..., 1, :, :], x0))
                           for x, x0 in zip(ptips, tips)))
        return genes, grads, fsum / V

    # -- reproduce (reference: :343-385) ----------------------------------
    def _reproduce(self, pa_g, pa_gr, pa_ext, pb_g, pb_gr, pb_ext, proto_g, off_gr_prev,
                   r):
        """One child per row from parents a and b and a prototype (genes and
        gradients ``(R, V)``, extinctions ``(R,)``); ``r (9, R, V)``
        uniforms.  Returns ``(genes, gradient)``."""
        p = self.ctx.problem
        V = pa_g.shape[-1]
        g = pa_g * (1 - r[0]) + pb_g * r[0]
        g = g + pa_gr * r[1] + pb_gr * r[2]
        storage = g
        ext = (0.5 * (pa_ext + pb_ext))[:, None]
        mut_p = ext * (1.0 - 1.0 / V) + 1.0 / V      # (:332-337)
        mut_s = p.aspan * ext                        # (:153-158)
        g = g + torch.where(r[3] < mut_p, (r[4] * 2 - 1) * mut_s, 0.0)
        a = r[5] * (0.5 * (pa_g + pb_g) - g)
        b = r[6] * (proto_g - g)
        g = g + a * (1 - r[7]) + b * r[7]
        g = self.ctx.clip(g)
        return g, r[8] * off_gr_prev + g - storage

    # -- evolve (reference: :501-548) --------------------------------------
    def step(self, st: Bio1State, data, draws: Optional[Bio1Draws] = None) -> Bio1State:
        """One step of every row, replayed from a CUDA graph on the card
        (:class:`~bio_ik_tpu_torch.graphs.Replay`); ``draws`` from the
        state's generator when None."""
        if draws is None:
            draws = self.draw_step(st.generator, st.genes.shape[0])
        return Bio1State(st.generator, *self._replay(tuple(st[1:]), data, draws))

    def _step(self, st: Bio1State, data, draws: Bio1Draws) -> Bio1State:
        ctx = self.ctx
        R, N, V = st.genes.shape
        E = self.elites
        d1 = _lead(data, 1)

        # the elites: greedy exploit
        e_genes, e_grads, e_fit = self._exploit(st.genes[:, :E], st.grads[:, :E], d1,
                                                draws.exploit)

        # the children: pool-shrinking reproduction, one child per row at a
        # time; a child of an empty pool is a reroll (:526-533, whose
        # fitness is also the random mix, :250)
        rg = self._reroll(draws.reroll_u, draws.reroll_t)              # (C, R, V)
        rf = self._fitness(rg.transpose(0, 1), d1,
                           None if draws.reroll_w is None else draws.reroll_w.transpose(0, 1))
        pool = torch.ones((R, N), dtype=torch.bool, device=st.genes.device)
        slot = torch.arange(N, device=st.genes.device)
        c_genes, c_grads, c_fit = [], [], []
        for c in range(N - E):
            ia, ib, ip = (_triangular_pick(draws.gumbel[c, j], pool) for j in range(3))
            cg, cgr = self._reproduce(
                _take(st.genes, ia), _take(st.grads, ia), _take(st.extinction, ia),
                _take(st.genes, ib), _take(st.grads, ib), _take(st.extinction, ib),
                _take(st.genes, ip), st.grads[:, E + c], draws.repro[c])
            # offspring are evaluated with the random mix (:384)
            cf = self._fitness(cg, data, None if draws.child_w is None else draws.child_w[c])
            empty = ~pool.any(dim=-1)
            cg = torch.where(empty[:, None], rg[c], cg)
            cgr = torch.where(empty[:, None], 0.0, cgr)
            cf = torch.where(empty, rf[:, c], cf)
            # remove beaten parents from the pool (:518-533)
            beat_a = (cf < _take(st.fitness, ia)) & ~empty
            beat_b = (cf < _take(st.fitness, ib)) & ~empty
            pool = pool & ~((slot == ia[:, None]) & beat_a[:, None])
            pool = pool & ~((slot == ib[:, None]) & beat_b[:, None])
            c_genes.append(cg)
            c_grads.append(cgr)
            c_fit.append(cf)

        genes = torch.cat([e_genes, torch.stack(c_genes, 1)], dim=1)
        grads = torch.cat([e_grads, torch.stack(c_grads, 1)], dim=1)
        fit = torch.cat([e_fit, torch.stack(c_fit, 1)], dim=1)
        order = torch.argsort(fit, dim=-1, stable=True)
        genes, grads, fit = _gather_n(genes, order), _gather_n(grads, order), fit.gather(1, order)
        ext = self._extinctions(fit)

        # the solution update with the balanced fitness (:314-330); one FK
        # for the incumbent and the new best
        pair = torch.stack([st.solution, genes[:, 0]], dim=1)          # (R, 2, V)
        tips = ctx.tips_frame(d1["seed_full"], pair)
        f_pair = self._fitness(pair, d1, tips=tips)
        sol_f, f_best = f_pair[:, 0], f_pair[:, 1]
        improved = f_best < sol_f
        solution = torch.where(improved[:, None], genes[:, 0], st.solution)
        if self.no_wipeout:
            return Bio1State(st.generator, genes, grads, fit, ext, solution)

        # the wipeout check (checkWipeout, :277-301): restart unless some
        # single-variable probe of the best individual improves it
        he = self._heuristic_errors(Frame(pos=tips.pos[:, 1], quat=tips.quat[:, 1]), data)
        eye = torch.eye(V, dtype=genes.dtype, device=genes.device)
        g0 = genes[:, :1]
        cands = torch.cat([ctx.clip(g0 + eye * (draws.wipe_up * he)[:, None]),
                           ctx.clip(g0 - eye * (draws.wipe_down * he)[:, None])], dim=1)
        stuck = ~torch.any(self._fitness(cands, d1) < f_best[:, None], dim=-1)
        do_wipe = stuck & ~improved

        w_genes, w_grads, w_fit, w_ext = self._population_from(
            solution, data, draws.pop_u, draws.pop_t, draws.pop_w)
        wipe3 = do_wipe[:, None, None]
        genes = torch.where(wipe3, w_genes, genes)
        grads = torch.where(wipe3, w_grads, grads)
        fit = torch.where(do_wipe[:, None], w_fit, fit)
        ext = torch.where(do_wipe[:, None], w_ext, ext)
        # the second tryUpdateSolution after the restart (:547)
        f2 = self._fitness(w_genes[:, 0], data)
        solution = torch.where((do_wipe & (f2 < sol_f))[:, None], w_genes[:, 0], solution)
        return Bio1State(st.generator, genes, grads, fit, ext, solution)

    def solution(self, st: Bio1State, data):
        return st.solution, self.ctx.fitness_exact(st.solution, data)

    def inject(self, st: Bio1State, qa, fitness):
        """Absorb a migrant into the worst population slot (see
        Solver.inject)."""
        genes, grads, fit = st.genes.clone(), st.grads.clone(), st.fitness.clone()
        genes[:, -1] = qa.to(genes.dtype)
        grads[:, -1] = 0.0
        fit[:, -1] = fitness.to(fit.dtype)
        return st._replace(genes=genes, grads=grads, fitness=fit)


def _gather_n(x, order):
    """``x (R, N, V)`` reordered along N by ``order (R, N)``."""
    return x.gather(1, order[..., None].expand(x.shape))


register_solver("bio1")(lambda ctx, config: Bio1Solver(ctx, config))
