"""Gradient-descent solver family (``gd``, ``gd_r``, ``gd_c``, ``_2/_4/_8``).

Port of :mod:`bio_ik_tpu.solvers.gd` (reference: IKGradientDescent,
src/ik_gradient.cpp:136-266).  One step per row: a 2-point numeric gradient
(one batched fitness call over the ``(2V, V)`` probes), its L1
normalization to ``jd = 1e-4``, a 3-point line probe with a linear step
estimate, and the policy of the variant (template parameter ``if_stuck``):

  * ``gd``   — keep the step only if the fitness improves;
  * ``gd_r`` — likewise, and restart from a random configuration at the
    next step when it does not;
  * ``gd_c`` — always take the step ("continue").

The ``_2/_4/_8`` suffixes set the default island count (the thread counts
in the reference's solver names, ik_gradient.cpp:253-266).  Every tensor
carries a leading row axis (scenario × island).  The gradient needs
``SolverConfig(dtype="float64")`` for precision, as the reference computes
in double: in float32 the rotation term's differences drown in the FK's
rounding near the goal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..graphs import Replay
from .base import Solver, SolverContext, register_solver
from .bio2 import _lead

__all__ = ["GDSolver", "GDState"]


class GDState(NamedTuple):
    generator: torch.Generator
    qa: torch.Tensor            # (R, V) current configuration
    fitness: torch.Tensor       # (R,) its fitness
    best: torch.Tensor          # (R, V) best so far
    best_fitness: torch.Tensor  # (R,)
    reset: torch.Tensor         # (R,) bool: restart at the next step (gd_r)


class GDSolver(Solver):
    def __init__(self, ctx: SolverContext, config, if_stuck=" ", islands=1):
        super().__init__(ctx, config)
        self.if_stuck = if_stuck
        self.default_islands = islands
        self._replay = Replay(lambda st, data, rand_u: tuple(
            self._step(GDState(None, *st), data, rand_u)[1:]))

    def init(self, generator, data, randomize):
        ctx = self.ctx
        seed = data["seed_active"].to(ctx.problem.amin.dtype)
        qa = torch.where(randomize[:, None],
                         ctx.random_config(generator, seed.shape[:1]), seed)
        f = ctx.fitness_exact(qa, data)
        return GDState(generator=generator, qa=qa, fitness=f, best=qa, best_fitness=f,
                       reset=torch.zeros_like(f, dtype=torch.bool))

    def step(self, st: GDState, data, rand_u: Optional[torch.Tensor] = None) -> GDState:
        """One step of every row, replayed from a CUDA graph on the card
        (:class:`~bio_ik_tpu_torch.graphs.Replay`); ``rand_u (R, V)`` are
        the uniforms of the random restart (drawn from the state's generator
        when None)."""
        if rand_u is None:
            rand_u = torch.rand(st.qa.shape, generator=st.generator, dtype=st.qa.dtype,
                                device=st.qa.device)
        return GDState(st.generator, *self._replay(tuple(st[1:]), data, rand_u))

    def _step(self, st: GDState, data, rand_u) -> GDState:
        ctx, p = self.ctx, self.ctx.problem
        R, V = st.qa.shape
        dt, dev = st.qa.dtype, st.qa.device
        # random restart where flagged (reference: ik_gradient.cpp:161-167)
        qa = torch.where(st.reset[:, None], p.amin + rand_u * (p.amax - p.amin), st.qa)

        # 2-point numeric gradient (reference: ik_gradient.cpp:171-188,
        # jd = 1e-4), one batched fitness call that also gives a restarted
        # row's fitness
        jd = torch.full((), 1e-4, dtype=dt, device=dev)
        eye = torch.eye(V, dtype=dt, device=dev) * jd
        cand = torch.cat([qa[:, None], qa[:, None] - eye, qa[:, None] + eye], dim=1)
        d1 = _lead(data, 1)
        fc = ctx.fitness_exact(cand, d1)                               # (R, 1 + 2V)
        f0 = torch.where(st.reset, fc[:, 0], st.fitness)
        g = fc[:, 1 + V:] - fc[:, 1:1 + V]
        # L1 normalization scaled to jd (reference: ik_gradient.cpp:191-196)
        g = g * (jd / (torch.sum(torch.abs(g), dim=-1, keepdim=True) + 1e-4))

        # 3-point line probe with a linear step estimate
        # (reference: ik_gradient.cpp:199-221)
        fp = ctx.fitness_exact(torch.stack([qa - g, qa + g], dim=1), d1)   # (R, 2)
        p1, p3 = fp[:, 0], fp[:, 1]
        joint_diff = ((p1 + p3) * 0.5) / ((p3 - p1) * 0.5)
        joint_diff = torch.where(torch.isfinite(joint_diff), joint_diff, 0.0)
        stepped = ctx.clip(qa - g * joint_diff[:, None])
        f_stepped = ctx.fitness_exact(stepped, data)

        if self.if_stuck == "c":
            new_qa, new_f = stepped, f_stepped
            reset = torch.zeros_like(st.reset)
        else:
            improved = f_stepped < f0
            new_qa = torch.where(improved[:, None], stepped, qa)
            new_f = torch.where(improved, f_stepped, f0)
            reset = ~improved if self.if_stuck == "r" else torch.zeros_like(st.reset)
        better = new_f < st.best_fitness
        return GDState(generator=st.generator, qa=new_qa, fitness=new_f,
                       best=torch.where(better[:, None], new_qa, st.best),
                       best_fitness=torch.where(better, new_f, st.best_fitness),
                       reset=reset)

    def solution(self, st: GDState, data):
        return st.best, st.best_fitness

    def inject(self, st: GDState, qa, fitness):
        """Adopt the migrant as the working point where it beats the current
        one (see Solver.inject)."""
        take = fitness < st.fitness
        return st._replace(
            qa=torch.where(take[:, None], qa, st.qa),
            fitness=torch.where(take, fitness, st.fitness),
            best=torch.where((fitness < st.best_fitness)[:, None], qa, st.best),
            best_fitness=torch.minimum(fitness, st.best_fitness))


for _name, _stuck, _islands in [
    ("gd", " ", 1), ("gd_2", " ", 2), ("gd_4", " ", 4), ("gd_8", " ", 8),
    ("gd_r", "r", 1), ("gd_r_2", "r", 2), ("gd_r_4", "r", 4), ("gd_r_8", "r", 8),
    ("gd_c", "c", 1), ("gd_c_2", "c", 2), ("gd_c_4", "c", 4), ("gd_c_8", "c", 8),
]:
    register_solver(_name)(
        lambda ctx, config, _s=_stuck, _i=_islands: GDSolver(ctx, config, _s, _i))
