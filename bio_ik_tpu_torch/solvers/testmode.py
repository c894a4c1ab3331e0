"""Diagnostic solver mode ``test``.

Port of :mod:`bio_ik_tpu.solvers.testmode` (reference: IKTest,
src/ik_test.cpp:40-137): compares the first-order tip-frame linearizer
with exact FK on randomly perturbed configurations (±0.1 rad,
ik_test.cpp:96) and reports the mean position and rotation error of the
approximation.  ``step`` is a no-op (ik_test.cpp:132) and the solution is
the seed; the value of the mode is the error statistics, kept per row in
the state and printed from the host at init (the reference's LOG lines,
ik_test.cpp:118-127).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kinematics.approx import apply_deltas
from ..math.quat import quat_angle_atan2, quat_normalize
from .base import Solver, SolverContext, register_solver

__all__ = ["TestSolver", "TestState"]

_N_PROBES = 64      # perturbed configurations per row
_AMPLITUDE = 0.1    # reference: random(-0.1, 0.1) rad, ik_test.cpp:96


class TestState(NamedTuple):
    qa: torch.Tensor        # (R, V) the seed
    fitness: torch.Tensor   # (R,)
    pos_err: torch.Tensor   # (R,) mean |approx_pos − exact_pos|
    rot_err: torch.Tensor   # (R,) mean shortest-path angle(approx, exact)


class TestSolver(Solver):
    default_islands = 1

    def __init__(self, ctx: SolverContext, config):
        super().__init__(ctx, config)
        if ctx.linearize is None:
            raise ValueError("test mode requires link goals")

    def init(self, generator, data, randomize=None, dq: Optional[torch.Tensor] = None):
        """``dq (R, 64, V)``: the probes' offsets, uniform in [−0.1, 0.1)
        (drawn from ``generator`` when None); ``randomize`` is ignored, as
        in JAX testmode.py:46."""
        ctx = self.ctx
        qa0 = data["seed_active"].to(ctx.problem.amin.dtype)
        tips0, deltas = ctx.linearize(ctx.qfull(data["seed_full"], qa0))
        if dq is None:
            u = torch.rand(qa0.shape[:1] + (_N_PROBES, ctx.nvars), generator=generator,
                           dtype=qa0.dtype, device=qa0.device)
            dq = u * (2 * _AMPLITUDE) - _AMPLITUDE
        qs = ctx.clip(qa0[:, None] + dq)
        approx = apply_deltas(tips0, deltas, qs - qa0[:, None])       # (R, N, T, 7)
        exact = ctx.tips_frame(data["seed_full"][:, None], qs)        # Frame (R, N, T)
        pos_err = torch.linalg.vector_norm(approx[..., 0:3] - exact.pos,
                                           dim=-1).mean(dim=(1, 2))
        # the atan2 form of the angle (JAX: the clamped arccos of the dot,
        # blind below ~1 mrad in float32; problem.check_solution)
        rot_err = quat_angle_atan2(quat_normalize(approx[..., 3:7]),
                                   exact.quat).mean(dim=(1, 2))
        for p, r in zip(pos_err.tolist(), rot_err.tolist()):
            print(f"ik test: mean dpos {p} mean drot {r} rad over {_N_PROBES} probes")
        return TestState(qa=qa0, fitness=ctx.fitness_exact(qa0, data),
                         pos_err=pos_err, rot_err=rot_err)

    def step(self, st: TestState, data) -> TestState:
        return st  # no-op (reference: ik_test.cpp:132)

    def solution(self, st: TestState, data):
        return st.qa, st.fitness


register_solver("test")(lambda ctx, config: TestSolver(ctx, config))
