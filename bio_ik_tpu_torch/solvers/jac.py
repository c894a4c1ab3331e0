"""Pseudoinverse-Jacobian solver (``jac``, ``jac_2/_4/_8``).

Port of :mod:`bio_ik_tpu.solvers.jac` (reference: IKJacobianBase /
IKJacobian, src/ik_gradient.cpp:42-133, 269-292): per step and row, the
tip→goal twist errors, the least-squares solution of the stacked system
``J Δq = t`` and the clipped update.  Both sides are in world coordinates
(a per-tip rotation of the reference's tip-local system: the same
least-squares solution).

The solve is the minimum-norm least-squares solution through the SVD
pseudoinverse with the cutoff ``eps · max(M, N)`` relative to the largest
singular value — what ``jnp.linalg.lstsq`` returns in the JAX package.
``torch.linalg.lstsq`` on CUDA offers only the ``gels`` routine, which
assumes full rank: the PR2 arm's 6 × 7 system is underdetermined, and a
singular pose is rank-deficient.

Goal frames come from the position, orientation and pose goal groups
(reference: tipObjectives from goal.frame, ik_gradient.cpp:62-68); a tip
without such a goal keeps a zero twist error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math.frame import Frame
from ..math.quat import quat_conj, quat_mul, quat_to_rotvec_wrapped
from .base import Solver, SolverContext, register_solver

__all__ = ["JacobianSolver", "JacState"]


class JacState(NamedTuple):
    qa: torch.Tensor    # (R, V)


class JacobianSolver(Solver):
    def __init__(self, ctx: SolverContext, config, islands=1):
        super().__init__(ctx, config)
        self.default_islands = islands
        if ctx.jacobian is None:
            raise ValueError("jac solver requires link goals")
        # the goal groups that define tip objective frames
        self._objective_groups = [
            (i, grp) for i, grp in enumerate(ctx.problem.primary)
            if grp.goal_type in ("position", "orientation", "pose")]

    def _objectives(self, tips0: Frame, data) -> Frame:
        """Per-tip goal frames ``(R, T, ·)``; a component no goal constrains
        is the current tip's (zero twist error)."""
        pos, quat = tips0.pos.clone(), tips0.quat.clone()
        for gi, grp in self._objective_groups:
            gdata = data["primary"][gi]
            slots = grp.index("tip_slots", pos.device)
            if grp.goal_type in ("position", "pose"):
                pos[:, slots] = gdata["position"].to(pos.dtype)
            if grp.goal_type in ("orientation", "pose"):
                quat[:, slots] = gdata["orientation"].to(quat.dtype)
        return Frame(pos=pos, quat=quat)

    def init(self, generator, data, randomize):
        ctx = self.ctx
        seed = data["seed_active"].to(ctx.problem.amin.dtype)
        return JacState(qa=torch.where(
            randomize[:, None], ctx.random_config(generator, seed.shape[:1]), seed))

    def step(self, st: JacState, data) -> JacState:
        ctx = self.ctx
        tips0, J = ctx.jacobian(ctx.qfull(data["seed_full"], st.qa))   # J (R, T, 6, V)
        obj = self._objectives(tips0, data)
        # the twist toward the goal, world frame (see the module docstring)
        rot = quat_to_rotvec_wrapped(quat_mul(obj.quat, quat_conj(tips0.quat)))
        t = torch.cat([obj.pos - tips0.pos, rot], dim=-1).reshape(st.qa.shape[0], -1)
        A = J.reshape(J.shape[0], -1, J.shape[-1])                      # (R, 6T, V)
        dq = (torch.linalg.pinv(A) @ t[..., None])[..., 0]
        dq = torch.where(torch.isfinite(dq), dq, 0.0)
        return JacState(qa=ctx.clip(st.qa + dq))

    def solution(self, st: JacState, data):
        return st.qa, self.ctx.fitness_exact(st.qa, data)


for _name, _islands in [("jac", 1), ("jac_2", 2), ("jac_4", 4), ("jac_8", 8)]:
    register_solver(_name)(
        lambda ctx, config, _i=_islands: JacobianSolver(ctx, config, _i))
