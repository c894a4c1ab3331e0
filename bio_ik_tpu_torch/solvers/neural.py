"""Neural-network solver family (``neural``, ``neural2``).

Port of :mod:`bio_ik_tpu.solvers.neural` (reference: the FANN-based
IKNeural and IKNeural2, src/ik_neural.cpp:83-690):

  * ``neural`` — an MLP (6T + V, 50, V) maps each tip's twist toward its
    goal and the current joint values to Δq, applied at half length each
    step (ik_neural.cpp:135-427);
  * ``neural2`` — an MLP (7T, 50, 50, V) regresses the joint values from
    the goal poses (ik_neural.cpp:432-689).

The network trains at construction, on the solver's device: Adam at 1e-3
(``torch.optim.Adam``, whose defaults are ``optax.adam``'s) for
``config.neural_train_steps`` steps, each on a fresh batch of 256 exact-FK
samples — random in-bounds configurations and, for ``neural``, a Gaussian
perturbation of each (the JAX package's ``make_batch``, neural.py:163-177,
:230-236).  The initial weights (normal × √(2/d_in), zero biases) and the
batches come from one ``torch.Generator`` seeded from ``config.seed``.  No
weights are loaded from anywhere; :func:`bio_ik_tpu_torch.interop.mlp_params_from_jax`
carries the JAX package's into an :class:`MLP` for tests.

Pose-type goals only, as in the reference (the network consumes tip frame
errors); the produced configurations' fitness and acceptance go through
the whole goal system.  Every tensor carries a leading row axis.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch
from torch import nn

from ..graphs import Replay
from ..math.quat import quat_conj, quat_mul, quat_to_rotvec_wrapped
from .base import Solver, SolverContext, register_solver

__all__ = ["MLP", "NeuralSolver", "Neural2Solver", "NeuralState", "train"]

_HIDDEN = 50      # reference: layer sizes {input, 50, output}, ik_neural.cpp:287
_BATCH = 256
_DPOS = 0.1       # reference: perturbation scale, ik_neural.cpp:158-166


class MLP(nn.Module):
    """Dense layers of ``sizes`` with tanh between them (reference: FANN's
    symmetric sigmoid, ik_neural.cpp:289)."""

    def __init__(self, sizes: Sequence[int], dtype=torch.float32, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(din, dout, dtype=dtype, device=device)
            for din, dout in zip(sizes[:-1], sizes[1:]))
        with torch.no_grad():
            for lin in self.layers:
                din, dout = lin.in_features, lin.out_features
                w = torch.randn((din, dout), generator=generator, dtype=dtype,
                                device=device) * math.sqrt(2.0 / din)
                lin.weight.copy_(w.T)
                lin.bias.zero_()

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


def train(net: MLP, draw: Callable, build: Callable, steps: int, lr: float = 1e-3):
    """``steps`` Adam steps on the mean squared error of ``build(*draw(i)) →
    (X, Y)``; → the last step's loss (JAX neural.py:68-95).  On the card a
    step — ``build``, the network's forward and backward and Adam's update
    (``capturable``) — replays one CUDA graph
    (:class:`~bio_ik_tpu_torch.graphs.Replay`: its first calls run eagerly,
    so every step is one Adam step on its own draws) at one host launch a
    step."""
    opt = torch.optim.Adam(net.parameters(), lr=lr,
                           capturable=next(net.parameters()).is_cuda)

    def step(*raw):
        X, Y = build(*raw)
        loss = torch.mean(torch.square(net(X) - Y))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    run = Replay(step)
    loss = None
    with torch.enable_grad():
        for i in range(steps):
            loss = run(*draw(i))
    opt.zero_grad(set_to_none=True)
    return loss


class NeuralState(NamedTuple):
    generator: torch.Generator
    qa: torch.Tensor            # (R, V)
    best: torch.Tensor          # (R, V)
    best_fitness: torch.Tensor  # (R,)


class _NeuralBase(Solver):
    """Shared plumbing: the goals' tip frames, twist features, training."""

    default_islands = 1

    def __init__(self, ctx: SolverContext, config):
        super().__init__(ctx, config)
        if ctx.fk is None:
            raise ValueError("neural solvers require link goals")
        p = ctx.problem
        self._objective_groups = [
            (i, grp) for i, grp in enumerate(p.primary)
            if grp.goal_type in ("position", "orientation", "pose")]
        if not self._objective_groups:
            raise ValueError("neural solvers require pose-type goals")
        self._neutral = torch.as_tensor(p.model.neutral_q(), dtype=p.amin.dtype,
                                        device=p.device)

    def _train(self, sizes, seed: int):
        p = self.ctx.problem
        g = torch.Generator(device=p.device)
        g.manual_seed(seed)
        self.net = MLP(sizes, p.amin.dtype, p.device, g)
        self.final_loss = train(self.net, lambda i: self._draw(g), self._batch,
                                self.config.neural_train_steps)

    def _make_batch(self, g):
        """One training batch ``(X, Y)`` from ``g``'s draws."""
        return self._batch(*self._draw(g))

    def _uniforms(self, g):
        p = self.ctx.problem
        return torch.rand((_BATCH, self.ctx.nvars), generator=g, dtype=p.amin.dtype,
                          device=p.device)

    def _goal_tips(self, data, pos, quat):
        """Per-tip objective frames: the goals' where a pose-type goal sets
        them, else the given tip frames (reference: tipObjectives,
        ik_neural.cpp:300-320)."""
        pos, quat = pos.clone(), quat.clone()
        for gi, grp in self._objective_groups:
            gdata = data["primary"][gi]
            slots = grp.index("tip_slots", pos.device)
            if grp.goal_type in ("position", "pose"):
                pos[..., slots, :] = gdata["position"].expand(pos[..., slots, :].shape)
            if grp.goal_type in ("orientation", "pose"):
                quat[..., slots, :] = gdata["orientation"].expand(
                    quat[..., slots, :].shape)
        return pos, quat

    @staticmethod
    def _twist(tip_pos, tip_quat, goal_pos, goal_quat):
        """6-vector per tip: [Δpos, rotvec(goal·tip⁻¹)] (reference: twist
        inputs, ik_neural.cpp:326-356)."""
        rot = quat_to_rotvec_wrapped(quat_mul(goal_quat, quat_conj(tip_quat)))
        return torch.cat([goal_pos - tip_pos, rot], dim=-1)

    def _keep_better(self, st: NeuralState, qa, data) -> NeuralState:
        f = self.ctx.fitness_exact(qa, data)
        better = f < st.best_fitness
        return NeuralState(generator=st.generator, qa=qa,
                           best=torch.where(better[:, None], qa, st.best),
                           best_fitness=torch.where(better, f, st.best_fitness))

    def solution(self, st: NeuralState, data):
        return st.best, st.best_fitness


class NeuralSolver(_NeuralBase):
    """Iterative twist→Δq network (reference: IKNeural)."""

    def __init__(self, ctx: SolverContext, config):
        super().__init__(ctx, config)
        p = ctx.problem
        self._span = torch.where(torch.isfinite(p.aspan), p.aspan, 1.0)
        self._train((6 * ctx.ntips + ctx.nvars, _HIDDEN, ctx.nvars), config.seed + 12345)

    def _draw(self, g):
        u = self._uniforms(g)
        return u, torch.randn(u.shape, generator=g, dtype=u.dtype, device=u.device)

    def _batch(self, u, n):
        """Configurations, their perturbations, and the twist between their
        tip frames (JAX neural.py:163-177), from uniforms ``u`` and normals
        ``n``."""
        ctx, p = self.ctx, self.ctx.problem
        qa = p.amin + u * (p.amax - p.amin)
        dq = n * (self._span * (_DPOS / 2))
        qa2 = torch.clamp(qa + dq, p.aclip_min, p.aclip_max)
        f0 = ctx.fk(ctx.qfull(self._neutral, qa))
        f1 = ctx.fk(ctx.qfull(self._neutral, qa2))
        tw = self._twist(f0.pos, f0.quat, f1.pos, f1.quat)            # (B, T, 6)
        return torch.cat([tw.reshape(_BATCH, -1), qa], dim=-1), qa2 - qa

    def init(self, generator, data, randomize):
        ctx = self.ctx
        seed = data["seed_active"].to(ctx.problem.amin.dtype)
        qa = torch.where(randomize[:, None],
                         ctx.random_config(generator, seed.shape[:1]), seed)
        return NeuralState(generator=generator, qa=qa, best=qa,
                           best_fitness=ctx.fitness_exact(qa, data))

    def step(self, st: NeuralState, data) -> NeuralState:
        ctx = self.ctx
        tips = ctx.tips_frame(data["seed_full"], st.qa)
        gpos, gquat = self._goal_tips(data, tips.pos, tips.quat)
        tw = self._twist(tips.pos, tips.quat, gpos, gquat)
        with torch.no_grad():
            dq = self.net(torch.cat([tw.reshape(st.qa.shape[0], -1), st.qa], dim=-1))
        # damped application (reference: fractional steps, ik_neural.cpp:358-427)
        return self._keep_better(st, ctx.clip(st.qa + dq * 0.5), data)


class Neural2Solver(_NeuralBase):
    """Direct pose→q regression (reference: IKNeural2, 2 steps)."""

    def __init__(self, ctx: SolverContext, config):
        super().__init__(ctx, config)
        self._train((7 * ctx.ntips, _HIDDEN, _HIDDEN, ctx.nvars), config.seed + 54321)

    def _draw(self, g):
        return (self._uniforms(g),)

    def _batch(self, u):
        """Configurations and their tip poses (JAX neural.py:230-236), from
        uniforms ``u``."""
        ctx, p = self.ctx, self.ctx.problem
        qa = p.amin + u * (p.amax - p.amin)
        f0 = ctx.fk(ctx.qfull(self._neutral, qa))
        return torch.cat([f0.pos, f0.quat], dim=-1).reshape(_BATCH, -1), qa

    def init(self, generator, data, randomize=None):
        """Every row from the seed (JAX neural.py:245-249)."""
        qa = data["seed_active"].to(self.ctx.problem.amin.dtype)
        return NeuralState(generator=generator, qa=qa, best=qa,
                           best_fitness=self.ctx.fitness_exact(qa, data))

    def step(self, st: NeuralState, data) -> NeuralState:
        ctx = self.ctx
        tips = ctx.tips_frame(data["seed_full"], st.qa)
        gpos, gquat = self._goal_tips(data, tips.pos, tips.quat)
        with torch.no_grad():
            qa = self.net(torch.cat([gpos, gquat], dim=-1).reshape(st.qa.shape[0], -1))
        return self._keep_better(st, ctx.clip(qa), data)


register_solver("neural")(lambda ctx, config: NeuralSolver(ctx, config))
register_solver("neural2")(lambda ctx, config: Neural2Solver(ctx, config))
