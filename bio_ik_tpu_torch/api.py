"""Top-level solve API: scenario-batched solving and adaptive retries.

Port of :mod:`bio_ik_tpu.api` for the batched throughput path
(reference: src/kinematics_plugin.cpp:437-655, src/ik_parallel.h:90-277):
``IKSolver.solve_batch`` on the fused engine (its fullstep tier for
revolute/prismatic chains, its species tier for floating/planar ones) and
``AdaptiveBatchSolver``'s on-device multi-phase pipeline over either tier.  ``solve``,
``search``, the unfused solvers and ``elite_migration`` wait for ROADMAP.md
port queue item 5, ``solve_until`` for item 2.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig
from .engine import FusedBio2Engine, fold_in
from .goals import Goal
from .interop import tree_map
from .problem import Problem
from .robot.model import RobotModel
from .solvers.base import SolverContext

__all__ = ["IKSolver", "IKResult", "AdaptiveBatchSolver"]

# bio2 family: the reference's concurrency() (ik_evolution_2.cpp:649)
_DEFAULT_ISLANDS = 4


class IKResult(NamedTuple):
    q: torch.Tensor          # full variable vector of the winner (..., Vfull)
    success: torch.Tensor    # bool: winner passed the acceptance test
    fitness: torch.Tensor    # primary fitness of the winner
    qa: torch.Tensor         # active variables of the winner (..., V)


def _check_device(model: RobotModel, device):
    if device is not None and torch.device(device).type != model.device.type:
        raise ValueError(f"device {device} differs from the model's "
                         f"{model.device}; build the RobotModel on it")


class IKSolver:
    """Solver for one robot + goal structure (reference: the plugin's
    ``initialize``, kinematics_plugin.cpp:191-335).  Runs on the model's
    device — the card unless the model was built with ``device="cpu"``."""

    def __init__(
        self,
        model: RobotModel,
        goals: Sequence[Goal],
        config: SolverConfig = DEFAULT_CONFIG,
        fixed_joints: Sequence[str] = (),
        active_variables: Optional[Sequence[int]] = None,
        device=None,
    ):
        _check_device(model, device)
        if config.counter:
            # JAX records every solve in a SolveStats (api.py:209-217)
            raise NotImplementedError(
                "counter=True (per-solve statistics) is not ported yet "
                "(ROADMAP.md, port queue item 6)")
        self.model = model
        self.config = config
        self.device = model.device
        self.problem = Problem(model, goals, fixed_joints=fixed_joints,
                               active_variables=active_variables, config=config)
        self.ctx = SolverContext(self.problem)
        self.islands = config.islands or _DEFAULT_ISLANDS
        self.engine = None
        if config.fused == "off" or config.elite_migration:
            self.unsupported = ("the unfused solvers are not ported yet "
                                "(ROADMAP.md, port queue item 5)")
        else:
            self.unsupported = FusedBio2Engine.supports(self)
            if self.unsupported is None:
                self.engine = FusedBio2Engine(self)

    @classmethod
    def for_tips(cls, model: RobotModel, tip_links: Sequence[str],
                 config: SolverConfig = DEFAULT_CONFIG, **kwargs) -> "IKSolver":
        """Default-goal construction mirroring the reference plugin's
        ``load()`` (kinematics_plugin.cpp:273-330): one PoseGoal per tip,
        plus the configured regularizers."""
        from .goals import (AvoidJointLimitsGoal, CenterJointsGoal,
                            MinimalDisplacementGoal, PoseGoal)

        rs = 0.0 if config.position_only_ik else config.rotation_scale
        goals = [PoseGoal(link=t, rotation_scale=rs) for t in tip_links]
        if config.center_joints_weight > 0:
            goals.append(CenterJointsGoal(weight=config.center_joints_weight))
        if config.avoid_joint_limits_weight > 0:
            goals.append(AvoidJointLimitsGoal(weight=config.avoid_joint_limits_weight))
        if config.minimal_displacement_weight > 0:
            goals.append(MinimalDisplacementGoal(
                weight=config.minimal_displacement_weight))
        return cls(model, goals, config, **kwargs)

    def make_data(self, q_seed_full) -> Dict[str, Any]:
        return self.problem.make_data(q_seed_full)

    def _rewrap(self, qa, seed_active):
        """Shift revolute angles by 2π multiples toward the seed, wrap into
        limits, clamp (reference: kinematics_plugin.cpp:580-613; skipped
        with mimic joints, as in the reference)."""
        if self.model.mimic_vars:
            return qa
        p = self.problem
        av = np.asarray(p.active_vars)
        rev = torch.as_tensor(self.model.var_is_revolute[av], device=qa.device)
        two_pi = 2.0 * math.pi
        r = seed_active
        v = qa - torch.round((qa - r) / two_pi) * two_pi
        hi, lo = p.amax, p.amin
        v = v - torch.ceil(torch.clamp(v - hi, min=0.0) / two_pi) * two_pi
        v = v + torch.ceil(torch.clamp(lo - v, min=0.0) / two_pi) * two_pi
        v = torch.minimum(torch.maximum(v, lo), hi)
        return torch.where(rev, v, qa)

    def solve_batch(self, keys, data) -> IKResult:
        """Solve B queries at once.  Every leaf of ``data`` carries a
        leading batch axis; ``keys`` is a ``(B, 2)`` integer tensor of
        32-bit words (a raw JAX ``PRNGKey`` per scenario)."""
        if self.engine is None:
            raise NotImplementedError(self.unsupported)
        return self.engine.solve_batch(keys, data)

    def solve(self, q_seed, key=None, data=None) -> IKResult:
        raise NotImplementedError(
            "single-query solve is not ported yet (ROADMAP.md, port queue "
            "item 5)")

    def search(self, q_seed, key=None, data=None, **kwargs):
        raise NotImplementedError(
            "search is not ported yet (ROADMAP.md, port queue item 5)")

    def solve_until(self, q_seed, key=None, data=None, timeout_s=None):
        raise NotImplementedError(
            "latency mode is not ported yet (ROADMAP.md, port queue item 2)")


class AdaptiveBatchSolver:
    """Multi-phase scenario-batched solving with failure compaction on the
    device: a first pass over the whole batch, then retries of the worst
    ``fractions[i]·B`` scenarios (failures first) with the next phase's
    island count and step budget (reference economics:
    ik_parallel.h:160-190)."""

    def __init__(self, model, goal_list, config=DEFAULT_CONFIG,
                 phases=((1, 8), (2, 32), (4, 64)), chunk_fraction=0.25,
                 fractions=None, device=None, **kwargs):
        _check_device(model, device)
        self.phases = phases
        self.chunk_fraction = chunk_fraction
        if fractions is None:
            fractions = tuple(
                0.75 if i == 0 else 0.25 / (2 ** (i - 1))
                for i in range(len(phases) - 1)
            )
        self.fractions = fractions
        # each phase checks acceptance once, at its end (one megastep
        # launch per phase on the fullstep tier; max_steps species
        # launches on the species tier)
        self.solvers = [
            IKSolver(model, goal_list,
                     config.replace(islands=i, max_steps=s, steps_per_check=s),
                     **kwargs)
            for i, s in phases
        ]

    @property
    def problem(self):
        return self.solvers[0].problem

    def make_data(self, q_seed_full):
        return self.solvers[0].make_data(q_seed_full)

    def _adaptive_on_device(self, keys, data):
        B = keys.shape[0]
        res = self.solvers[0].engine._solve_batch(keys, data)
        for phase_idx, solver in enumerate(self.solvers[1:], start=1):
            chunk = max(1, int(B * self.fractions[phase_idx - 1]))
            # failures first (stable sort keeps a deterministic order)
            order = torch.argsort(res.success.to(torch.int32), stable=True)
            idx = order[:chunk]
            sub_data = tree_map(lambda x: x[idx], data)
            sub = solver.engine._solve_batch(fold_in(keys[idx], phase_idx),
                                             sub_data)
            res = self._take(res, idx, sub)
        return res

    @staticmethod
    def _take(res, idx, sub):
        """Adopt a retry where it succeeds and the incumbent does not, or
        ties on success with lower fitness — with the retry's OWN success
        flag (the JAX package's rule, api.py:102-116)."""
        r_ok = res.success[idx]
        take = (sub.success & ~r_ok) | (
            (sub.success == r_ok) & (sub.fitness < res.fitness[idx]))

        def put(full, new):
            t = take[:, None] if full.dim() > 1 else take
            return full.index_copy(0, idx, torch.where(t, new, full[idx]))

        return IKResult(q=put(res.q, sub.q), success=put(res.success, sub.success),
                        fitness=put(res.fitness, sub.fitness),
                        qa=put(res.qa, sub.qa))

    def solve_batch(self, keys, data) -> IKResult:
        for s in self.solvers:
            if s.engine is None:
                raise NotImplementedError(s.unsupported)
        return self._adaptive_on_device(keys, data)
