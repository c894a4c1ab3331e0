"""Shared per-problem machinery and the solver registry.

Port of :mod:`bio_ik_tpu.solvers.base` (reference: src/ik_base.h:128-214
and IKFactory, utils.h:398-444).  A solver is an ``init / step /
solution / inject`` set over a state tuple whose tensors carry a leading
row axis — one row per island of each scenario — which the island path of
:mod:`bio_ik_tpu_torch.api` steps in lock-step.

The port registers every mode of the JAX package's registry: the bio2
family (``solvers/bio2.py``), bio1, the gd and jac families, ``test``, the
``optlib_*`` family and ``neural``/``neural2`` (``bio1.py``, ``gd.py``,
``jac.py``, ``testmode.py``, ``optlib.py``, ``neural.py``); any other name
raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..kinematics import make_fk, make_jacobian, make_linearizer
from ..math.frame import Frame
from ..problem import Problem

__all__ = ["SolverContext", "Solver", "register_solver", "make_solver",
           "solver_names"]


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
        if problem.tip_links:
            self.fk = make_fk(model, problem.tip_links)
            self.linearize = make_linearizer(model, problem.tip_links,
                                             problem.active_vars)
            self.jacobian = make_jacobian(model, problem.tip_links,
                                          problem.active_vars)
        else:
            self.fk = self.linearize = self.jacobian = None

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

    def fitness_combined_exact(self, qa, data):
        """Primary + secondary fitness via exact FK."""
        tips = self.tips_packed(data["seed_full"], qa)
        return self.problem.fitness_combined(tips, qa, data)

    def random_config(self, generator: torch.Generator, shape=()):
        """Uniform sample in the [min, max] box (reference: random(min,max)
        init, e.g. ik_evolution_2.cpp:628-629)."""
        p = self.problem
        u = torch.rand(tuple(shape) + (self.nvars,), generator=generator,
                       dtype=p.amin.dtype, device=p.amin.device)
        return p.amin + u * (p.amax - p.amin)

    def clip(self, qa):
        return torch.clamp(qa, self.problem.aclip_min, self.problem.aclip_max)

    def clip_tied(self, qa):
        """:meth:`clip`'s values with ``jnp.clip``'s gradient — 1 strictly
        inside, ½ at a bound, 0 outside — for the objectives differentiated
        through a clip (optlib's, bio2's L-BFGS phase): ``torch.maximum`` and
        ``torch.minimum`` split a tie as JAX does, where ``torch.clamp``
        passes all of it."""
        p = self.problem
        return torch.minimum(torch.maximum(p.aclip_min, qa), p.aclip_max)


class Solver:
    """Protocol of the solvers the island path steps.  Every state tensor
    and every data leaf carries a leading row axis (one row per island of
    each scenario); rows never interact.  Subclasses set
    ``default_islands`` (reference: concurrency(), ik_base.h:208)."""

    default_islands = 1

    def __init__(self, ctx: SolverContext, config):
        self.ctx = ctx
        self.config = config

    def init(self, generator: torch.Generator, data, randomize):
        """State of every row.  ``randomize (R,)`` bool: the rows that start
        from a uniform random configuration instead of the seed (JAX: island
        0 of each scenario starts from the seed, api.py:273)."""
        raise NotImplementedError

    def step(self, state, data):
        raise NotImplementedError

    def solution(self, state, data):
        """→ ``(qa (R, V), primary fitness (R,))`` of each row's incumbent."""
        raise NotImplementedError

    def inject(self, state, qa, fitness):
        """Elite migration hook: absorb a migrant ``(qa (R, V), fitness
        (R,))`` into each row.  Default: no-op (no reference analog — the
        reference's islands exchange nothing, ik_parallel.h:94-97)."""
        return state


_REGISTRY: Dict[str, Callable[[SolverContext, object], Solver]] = {}


def register_solver(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_solver(mode: str, ctx: SolverContext, config) -> Solver:
    """Instantiate a solver by mode name (reference: IKFactory::create,
    utils.h:398-444)."""
    _import_all()
    if mode in _REGISTRY:
        return _REGISTRY[mode](ctx, config)
    raise ValueError(f"unknown solver mode {mode!r}; available: {sorted(_REGISTRY)}")


def _import_all():
    from . import bio1 as _bio1  # noqa: F401
    from . import bio2 as _bio2  # noqa: F401
    from . import gd as _gd  # noqa: F401
    from . import jac as _jac  # noqa: F401
    from . import neural as _neural  # noqa: F401
    from . import optlib as _optlib  # noqa: F401
    from . import testmode as _testmode  # noqa: F401


def solver_names():
    _import_all()
    return sorted(_REGISTRY)
