"""Shared per-problem machinery.

Port of :class:`bio_ik_tpu.solvers.base.SolverContext` (reference:
src/ik_base.h:128-214), FK only: the linearizer and Jacobian
(``kinematics/approx.py``) arrive with the species tier (ROADMAP.md, port
queue item 3), and the solver registry with the unfused solvers (item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kinematics import make_fk
from ..math.frame import Frame
from ..problem import Problem

__all__ = ["SolverContext"]


class SolverContext:
    """Compiled kinematics + fitness plumbing for one Problem."""

    def __init__(self, problem: Problem):
        self.problem = problem
        model = problem.model
        self.av = np.asarray(problem.active_vars, dtype=np.int64)
        self._av_t = torch.as_tensor(self.av, device=problem.device)
        self.nvars = len(self.av)
        self.ntips = problem.ntips
        self.dtype = problem.dtype
        self.fk = make_fk(model, problem.tip_links) if problem.tip_links else None

    def qfull(self, seed_full, qa):
        """Scatter active values into the full variable vector (reference:
        genesToJointVariables, ik_evolution_2.cpp:101-107)."""
        base = seed_full.expand(qa.shape[:-1] + seed_full.shape[-1:]).clone()
        base[..., self._av_t] = qa
        return base

    def tips_frame(self, seed_full, qa) -> Frame:
        if self.fk is None:
            shape = qa.shape[:-1]
            z = qa.new_zeros(shape + (0, 3))
            return Frame(pos=z, quat=qa.new_zeros(shape + (0, 4)))
        return self.fk(self.qfull(seed_full, qa))

    def tips_packed(self, seed_full, qa):
        f = self.tips_frame(seed_full, qa)
        return torch.cat([f.pos, f.quat], dim=-1)

    def fitness_exact(self, qa, data):
        """Primary fitness via exact FK."""
        tips = self.tips_packed(data["seed_full"], qa)
        return self.problem.fitness(tips, qa, data)

    def random_config(self, generator: torch.Generator, shape=()):
        """Uniform sample in the [min, max] box (reference: random(min,max)
        init, e.g. ik_evolution_2.cpp:628-629)."""
        p = self.problem
        u = torch.rand(tuple(shape) + (self.nvars,), generator=generator,
                       dtype=p.amin.dtype, device=p.amin.device)
        return p.amin + u * (p.amax - p.amin)

    def clip(self, qa):
        return torch.clamp(qa, self.problem.aclip_min, self.problem.aclip_max)
