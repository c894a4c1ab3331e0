"""Quasi-Newton and derivative-free solver family (``optlib_*``).

Port of :mod:`bio_ik_tpu.solvers.optlib` (the counterpart of the
reference's optional cppoptlib wrapper, src/ik_cppoptlib.cpp:72-257):
``optlib_<variant>[_r][_2|_4|_8]`` with

  * ``lbfgs`` / ``bfgs`` — L-BFGS with the zoom line search, memory 10 / 50
    (:class:`~bio_ik_tpu_torch.solvers.lbfgs.QuasiNewton`, the port of the
    optax 0.2.6 ``optax.lbfgs`` the JAX package calls);
  * ``lbfgsb`` — the same, every inner update projected onto the box;
  * ``gd`` — gradient descent with the zoom line search (8 steps, the last
    stepsize as the next guess);
  * ``cgd`` — Polak-Ribière(+) conjugate gradient with the descent guard,
    ``nd`` — damped Newton from the exact Hessian, both with the 8-step
    geometric line probe;
  * ``nm`` — a Nelder-Mead-style simplex with masked replacement and shrink;
  * ``_r`` — a row whose step did not improve its best restarts from a
    uniform random configuration, its optimizer state re-initialized.

Every tensor carries a leading row axis (scenario × island); a step runs 4
inner updates of every row as batched tensor code.  The objective is the
exact primary fitness at the clipped configuration, differentiated by
autograd through :meth:`SolverContext.clip_tied` (``jnp.clip``'s gradient
at the bounds, where ``lbfgsb``'s iterates sit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..graphs import Replay
from .base import Solver, SolverContext, register_solver
from .bio2 import _lead
from .lbfgs import QuasiNewton, line_iteration, value_and_grad

__all__ = ["OptlibSolver", "OptlibState"]

_INNER_UPDATES = 4   # JAX optlib.py:47
_PROBE_STEPS = 8     # the geometric ladder of cgd's and nd's line probe


class OptlibState(NamedTuple):
    generator: torch.Generator
    qa: torch.Tensor            # (R, V) current configuration
    opt_state: tuple            # the variant's state, every leaf (R, ...)
    best: torch.Tensor          # (R, V) best so far
    best_fitness: torch.Tensor  # (R,)
    stuck: torch.Tensor         # (R,) bool: restart at the next step (_r)


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _where_rows(mask, a, b):
    """Per row: the state tree ``a`` where ``mask (R,)``, else ``b`` (every
    leaf carries the row axis first)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        leaves = (_where_rows(mask, x, y) for x, y in zip(a, b))
        return type(a)(*leaves) if hasattr(a, "_fields") else tuple(leaves)
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


class OptlibSolver(Solver):
    def __init__(self, ctx: SolverContext, config, variant="lbfgs",
                 reset_if_stuck=False, islands=1):
        super().__init__(ctx, config)
        self.default_islands = islands
        self.reset_if_stuck = reset_if_stuck
        self.variant = variant
        self.project = variant == "lbfgsb"
        self.opt = None
        if variant in ("lbfgs", "lbfgsb"):
            self.opt = QuasiNewton(memory=10)
        elif variant == "bfgs":
            self.opt = QuasiNewton(memory=50)
        elif variant == "gd":
            self.opt = QuasiNewton(memory=None, max_linesearch_steps=8)
        elif variant not in ("cgd", "nd", "nm"):
            raise ValueError(f"unknown optlib variant {variant!r}")
        # the objective's (value, gradient), value and (value, gradient,
        # Hessian) at x on data, and the line search's iteration with the
        # first, each replayed from a CUDA graph on the card
        self._vg = Replay(lambda x, data: value_and_grad(self._objective(data), x))
        self._f = Replay(lambda x, data: self._objective(data)(x))
        self._hess = Replay(lambda x, data: self._hessian(self._objective(data), x))
        self._line = None if self.opt is None else Replay(line_iteration(
            lambda x, data: value_and_grad(self._objective(data), x), self.opt.max_steps))

    def _evaluators(self, data):
        """``(vg, f, hessian, data)``: the first three of ``x`` alone."""
        return (lambda x: self._vg(x, data), lambda x: self._f(x, data),
                lambda x: self._hess(x, data), data)

    def _objective(self, data):
        """``f (R, ..., V) → (R, ...)``: the exact fitness at the clipped
        configuration (JAX optlib.py:93-98)."""
        ctx = self.ctx

        def f(qa):
            d = _lead(data, qa.dim() - 2) if qa.dim() > 2 else data
            return ctx.fitness_exact(ctx.clip_tied(qa), d)

        return f

    def _init_opt(self, qa, f):
        if self.opt is not None:
            return self.opt.init(qa)
        if self.variant == "cgd":
            return (torch.zeros_like(qa), torch.zeros_like(qa))   # (g_prev, d_prev)
        if self.variant == "nd":
            return ()
        # nm: the right-angled simplex about qa, one vertex per variable
        p = self.ctx.problem
        V = qa.shape[-1]
        eye = torch.eye(V, dtype=qa.dtype, device=qa.device)
        simplex = torch.cat([qa[:, None], qa[:, None] + 0.1 * (p.amax - p.amin) * eye],
                            dim=1)                                   # (R, V+1, V)
        return (simplex, f(simplex))

    def init(self, generator, data, randomize):
        ctx = self.ctx
        seed = data["seed_active"].to(ctx.problem.amin.dtype)
        qa = torch.where(randomize[:, None],
                         ctx.random_config(generator, seed.shape[:1]), seed)
        f = self._evaluators(data)[1]
        return OptlibState(generator=generator, qa=qa, opt_state=self._init_opt(qa, f),
                           best=qa, best_fitness=f(qa),
                           stuck=torch.zeros(qa.shape[:1], dtype=torch.bool,
                                             device=qa.device))

    # ---- inner updates (JAX optlib.py:119-195) ---------------------------
    @staticmethod
    def _line_probe(f, qa, d, f0):
        """``qa + t·d`` for t = 1, ½, …, 2⁻⁷ in one batched fitness call; the
        best point where it improves on ``f0`` (JAX optlib.py:52-60)."""
        ts = 2.0 ** -torch.arange(_PROBE_STEPS, dtype=qa.dtype, device=qa.device)
        cands = qa[:, None] + ts[:, None] * d[:, None]               # (R, 8, V)
        fs = f(cands)
        i = torch.argmin(fs, dim=-1, keepdim=True)
        fi = fs.gather(-1, i)[:, 0]
        ci = cands.gather(1, i[..., None].expand(-1, -1, qa.shape[-1]))[:, 0]
        better = fi < f0
        return torch.where(better[:, None], ci, qa), torch.where(better, fi, f0)

    def _inner_optax(self, ev, qa, opt_state):
        qa, opt_state = self.opt.update(self._vg, qa, opt_state, (ev[3],), self._line)
        if self.project:   # lbfgsb: the iterates live on the box
            qa = self.ctx.clip(qa)
        return qa, opt_state

    def _inner_cgd(self, ev, qa, opt_state):
        g_prev, d_prev = opt_state
        f0, g = ev[0](qa)
        denom = torch.clamp_min(_vdot(g_prev, g_prev), 1e-30)
        beta = torch.clamp_min(_vdot(g, g - g_prev) / denom, 0.0)    # PR+
        d = -g + beta[:, None] * d_prev      # d_prev unnormalized: standard PR+
        d = torch.where((_vdot(d, g) < 0)[:, None], d, -g)         # a descent direction
        d_unit = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-30)
        qa, _ = self._line_probe(ev[1], qa, d_unit, f0)
        return qa, (g, d)

    @staticmethod
    def _hessian(f, qa):
        """Value, gradient and Hessian ``(R, V, V)`` of every row, ``H[i, j] =
        ∂g_i/∂x_j`` as ``jax.hessian``: V backward passes through the
        gradient's graph (``SolverContext.qfull``'s in-place scatter keeps
        ``torch.func.hessian`` out)."""
        with torch.enable_grad():
            x = qa.detach().requires_grad_(True)
            v = f(x)
            (g,) = torch.autograd.grad(v.sum(), x, create_graph=True)
            rows = []
            for j in range(qa.shape[-1]):
                (h,) = torch.autograd.grad(g[:, j].sum(), x, retain_graph=True,
                                           allow_unused=True)
                rows.append(torch.zeros_like(qa) if h is None else h)
        return v.detach(), g.detach(), torch.stack(rows, dim=-2)

    def _inner_nd(self, ev, qa, opt_state):
        f0, g, H = ev[2](qa)
        V = qa.shape[-1]
        lam = 1e-4 * (torch.diagonal(H, dim1=-2, dim2=-1).abs().sum(-1) / V + 1.0)
        eye = torch.eye(V, dtype=qa.dtype, device=qa.device)
        # a singular system gives non-finite values, as jnp.linalg.solve does
        sol, _ = torch.linalg.solve_ex(H + lam[:, None, None] * eye, g[..., None],
                                       check_errors=False)
        d = -sol[..., 0]
        ok = torch.isfinite(d).all(dim=-1) & (_vdot(d, g) < 0)
        d = torch.where(ok[:, None], d, -g)
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-30)
        qa, _ = self._line_probe(ev[1], qa, d, f0)
        return qa, opt_state

    def _inner_nm(self, ev, qa, opt_state):
        f = ev[1]
        s, fv = opt_state
        order = torch.sort(fv, dim=-1, stable=True).indices
        s = s.gather(1, order[..., None].expand(s.shape))
        fv = fv.gather(1, order)
        c = torch.mean(s[:, :-1], dim=1)      # centroid of all but the worst
        xw, fw = s[:, -1], fv[:, -1]
        step = c - xw
        cands = torch.stack([c + step, c + 2.0 * step,           # reflect, expand
                             c + 0.5 * step, c - 0.5 * step], dim=1)   # contract
        fs = f(cands)                                            # (R, 4)
        k = torch.argmin(fs, dim=-1, keepdim=True)
        fk = fs.gather(1, k)[:, 0]
        ck = cands.gather(1, k[..., None].expand(-1, -1, s.shape[-1]))[:, 0]
        replace = fk < fw
        s = torch.cat([s[:, :-1], torch.where(replace[:, None], ck, xw)[:, None]], dim=1)
        fv = torch.cat([fv[:, :-1], torch.where(replace, fk, fw)[:, None]], dim=1)
        # the masked shrink toward the best vertex where nothing improved
        shrunk = s[:, :1] + 0.5 * (s - s[:, :1])
        shrunk_f = f(shrunk)
        s = torch.where(replace[:, None, None], s, shrunk)
        fv = torch.where(replace[:, None], fv, shrunk_f)
        best = torch.argmin(fv, dim=-1)
        return s[torch.arange(s.shape[0], device=s.device), best], (s, fv)

    def step(self, st: OptlibState, data, rand_u: Optional[torch.Tensor] = None
             ) -> OptlibState:
        """One step of every row (JAX optlib.py:197-229); ``rand_u (R, V)``
        are the uniforms of the ``_r`` restart (drawn from the state's
        generator when None)."""
        ctx, p = self.ctx, self.ctx.problem
        ev = self._evaluators(data)
        f = ev[1]
        qa0, opt_state = st.qa, st.opt_state
        if self.reset_if_stuck:
            if rand_u is None:
                rand_u = torch.rand(st.qa.shape, generator=st.generator,
                                    dtype=st.qa.dtype, device=st.qa.device)
            qa0 = torch.where(st.stuck[:, None], p.amin + rand_u * (p.amax - p.amin),
                              st.qa)
            opt_state = _where_rows(st.stuck, self._init_opt(qa0, f), opt_state)
        inner = {"cgd": self._inner_cgd, "nd": self._inner_nd,
                 "nm": self._inner_nm}.get(self.variant, self._inner_optax)
        qa = qa0
        for _ in range(_INNER_UPDATES):
            qa, opt_state = inner(ev, qa, opt_state)
        qa = ctx.clip(qa)
        qa = torch.where(torch.isfinite(qa).all(dim=-1, keepdim=True), qa, qa0)
        fv = f(qa)
        improved = fv < st.best_fitness
        stuck = ~improved if self.reset_if_stuck else torch.zeros_like(improved)
        return OptlibState(
            generator=st.generator, qa=qa, opt_state=opt_state,
            best=torch.where(improved[:, None], qa, st.best),
            best_fitness=torch.where(improved, fv, st.best_fitness), stuck=stuck)

    def solution(self, st: OptlibState, data):
        return st.best, st.best_fitness


for _variant in ("lbfgs", "bfgs", "lbfgsb", "gd", "cgd", "nd", "nm"):
    for _r in ("", "_r"):
        for _n, _i in (("", 1), ("_2", 2), ("_4", 4), ("_8", 8)):
            register_solver(f"optlib_{_variant}{_r}{_n}")(
                lambda ctx, config, _v=_variant, _rr=bool(_r), _ii=_i:
                OptlibSolver(ctx, config, _v, _rr, _ii))
