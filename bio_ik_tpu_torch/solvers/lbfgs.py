"""Batched L-BFGS and zoom line search over independent rows.

Port of the parts of optax 0.2.6 that the JAX package's ``optlib_*`` modes
(``bio_ik_tpu/solvers/optlib.py``) and bio2's L-BFGS memetic phase
(``bio2.py:190-219``) call: ``optax.lbfgs`` — ``scale_by_lbfgs`` (a circular
memory of parameter and gradient differences with their weights, the
two-loop recursion, and ``scale_init_precond``: the first step capped at
the unit ball) chained with ``scale(-1)`` and ``scale_by_zoom_linesearch``
(the strong-Wolfe zoom line search of ``optax/_src/linesearch.py``:
interval search, then cubic / quadratic / bisection zoom, the safe-step
fallback) — and ``optax.sgd(1.0)`` chained with the same line search, as
``optlib_gd`` composes it.

Every tensor carries leading row axes ``(...)`` (scenario × island, and
species in bio2) before the variable axis ``V``; rows never interact.
Values are ``(...)``; gradients come from autograd of the sum over rows.

The line search's loop.  Under ``vmap`` the JAX package runs optax's
``while_loop`` until every row is done and freezes the rows that are.  Here
the same loop runs batched with a per-row done mask, for at most
``max_linesearch_steps`` iterations, and stops early once every row is done
(one host read per iteration): a line search usually ends after one or two
evaluations, so running the full count (20 for L-BFGS) would evaluate the
objective ten times as often for the same result.  Each iteration costs one
value-and-gradient evaluation, at the stepsize each row's phase asks for
(the next trial of the interval search, or the zoom's middle), and the
stored value and gradient of the step taken are reused by the next update
(``optax.value_and_grad_from_state``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["LbfgsState", "ZoomState", "QuasiNewton", "QuasiNewtonState",
           "line_iteration", "value_and_grad"]

# optax scale_by_zoom_linesearch's defaults (linesearch.py:1331-1345)
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INCREASE = 2.0
_STEPSIZE_PRECISION = 1e-5
_TOL = 0.0


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def value_and_grad(f: Callable, x):
    """``f (..., V) → (...)`` and its gradient at ``x``: autograd of the sum
    over the rows, which are independent."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        v = f(x)
        (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach(), g


# --------------------------------------------------------------------------
# scale_by_lbfgs (optax transform.py:1573-1730)


class LbfgsState(NamedTuple):
    count: torch.Tensor      # (...) int64
    params: torch.Tensor     # (..., V) the previous parameters
    updates: torch.Tensor    # (..., V) the previous gradient
    dparams: torch.Tensor    # (..., m, V) parameter differences
    dupdates: torch.Tensor   # (..., m, V) gradient differences
    weights: torch.Tensor    # (..., m) 1 / ⟨dupdates, dparams⟩


def _lbfgs_init(params, memory: int) -> LbfgsState:
    z = params.new_zeros(params.shape[:-1] + (memory,) + params.shape[-1:])
    return LbfgsState(
        count=torch.zeros(params.shape[:-1], dtype=torch.int64, device=params.device),
        params=torch.zeros_like(params), updates=torch.zeros_like(params),
        dparams=z, dupdates=z.clone(), weights=params.new_zeros(z.shape[:-1]))


def _precondition(updates, dparams, dupdates, weights, scale, memory_idx):
    """The two-loop recursion (optax ``_precondition_by_lbfgs``,
    transform.py:1496-1555; Nocedal & Wright Algorithm 7.4), each row with
    its own memory index: the memory is first put in age order, oldest
    first.  Unused slots have weight 0 and change nothing."""
    m = weights.shape[-1]
    order = (memory_idx[..., None] + torch.arange(m, device=weights.device)) % m
    o3 = order[..., None].expand(order.shape + dparams.shape[-1:])
    dw, du = dparams.gather(-2, o3), dupdates.gather(-2, o3)
    rho = weights.gather(-1, order)
    vec = updates
    alphas = [None] * m
    for j in range(m - 1, -1, -1):
        alpha = rho[..., j] * _vdot(dw[..., j, :], vec)
        vec = vec + (-alpha)[..., None] * du[..., j, :]
        alphas[j] = alpha
    vec = scale[..., None] * vec
    for j in range(m):
        beta = rho[..., j] * _vdot(du[..., j, :], vec)
        vec = vec + (alphas[j] - beta)[..., None] * dw[..., j, :]
    return vec


def _lbfgs_update(grads, st: LbfgsState, params) -> Tuple[torch.Tensor, LbfgsState]:
    """The L-BFGS direction ``P_k g_k`` and the memory after storing the
    latest differences (optax ``scale_by_lbfgs.update_fn``,
    ``scale_init_precond=True``)."""
    m = st.weights.shape[-1]
    memory_idx = st.count % m
    prev_idx = (st.count - 1) % m
    dparams = params - st.params
    dupdates = grads - st.updates
    vd = _vdot(dupdates, dparams)
    weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
    first = (st.count == 0)
    dparams = torch.where(first[..., None], 0.0, dparams)
    dupdates = torch.where(first[..., None], 0.0, dupdates)
    weight = torch.where(first, 0.0, weight)
    slot = torch.arange(m, device=params.device) == prev_idx[..., None]   # (..., m)
    dpm = torch.where(slot[..., None], dparams[..., None, :], st.dparams)
    dum = torch.where(slot[..., None], dupdates[..., None, :], st.dupdates)
    wm = torch.where(slot, weight[..., None], st.weights)
    # gamma_k: ⟨du, dw⟩ / ‖du‖²; at the first step min(1, 1 / ‖g‖)
    num = _vdot(dupdates, dparams)
    den = _vdot(dupdates, dupdates)
    scale = torch.where(den > 0.0, num / den, 1.0)
    capped = torch.clamp(1.0 / torch.sqrt(_vdot(grads, grads)), max=1.0)
    scale = torch.where(st.count > 0, scale, capped)
    precond = _precondition(grads, dpm, dum, wm, scale, memory_idx)
    return precond, LbfgsState(count=st.count + 1, params=params, updates=grads,
                               dparams=dpm, dupdates=dum, weights=wm)


# --------------------------------------------------------------------------
# zoom line search (optax linesearch.py:576-1330, 1331-1646)


class ZoomState(NamedTuple):
    """``ScaleByZoomLinesearchState`` without its diagnostics."""

    learning_rate: torch.Tensor   # (...) the last stepsize
    value: torch.Tensor           # (...) the value at the step taken
    grad: torch.Tensor            # (..., V) the gradient there


def _zoom_init(params) -> ZoomState:
    shape = params.shape[:-1]
    return ZoomState(learning_rate=params.new_ones(shape),
                     value=params.new_full(shape, math.inf),
                     grad=torch.zeros_like(params))


class _Line(NamedTuple):
    """``ZoomLinesearchState``'s changing fields, each (...) or (..., V)."""

    count: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _select(mask, a: _Line, b: _Line) -> _Line:
    """Per row: ``a`` where ``mask``, else ``b``."""
    return _Line(*(torch.where(mask[..., None] if x.dim() > mask.dim() else mask, x, y)
                   for x, y in zip(a, b)))


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    de = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    ade = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    dv = value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init)
    de = torch.minimum(torch.maximum(ade, dv), de)
    de = torch.clamp_min(de, 0.0)
    return torch.where(torch.isnan(de), math.inf, de)


def _curvature_error(slope, slope_init):
    ce = torch.clamp_min(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(ce), math.inf, ce)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope ``fpa`` at a; NaN where there is none (optax ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    x1 = fb - fa - C * db
    x2 = fc - fa - C * dc
    A = (dc ** 2 * x1 + (-(db ** 2)) * x2) / denom
    B = ((-(dc ** 3)) * x1 + db ** 3 * x2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def zoom_linesearch(vg: Callable, params, updates, value, grad, guess,
                    max_steps: int, extra=(), line: Optional[Callable] = None):
    """A stepsize along ``updates`` from ``params`` that satisfies the strong
    Wolfe conditions, per row (optax ``zoom_linesearch`` with ``tol`` 0 and
    no maximal stepsize): → ``(stepsize, value, grad)`` at the step taken.
    ``vg(x, *extra) → (value, grad)``; ``value``/``grad`` at ``params``;
    ``guess (...)`` the first trial stepsize; ``line``: the loop's iteration
    (:func:`line_iteration` of ``vg``, or its replay)."""
    slope = _vdot(updates, grad)
    value_init, slope_init = value, slope
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, math.inf)
    false = torch.zeros(value.shape, dtype=torch.bool, device=value.device)
    st = _Line(count=torch.zeros(value.shape, dtype=torch.int64, device=value.device),
               stepsize=zero, value=value, grad=grad, slope=slope,
               decrease_error=inf, curvature_error=inf, interval_found=false,
               done=false, failed=false, low=zero, value_low=value, slope_low=slope,
               high=zero, value_high=value, slope_high=slope, cubic_ref=zero,
               value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
               safe_grad=grad)
    active = ~false
    line = line or line_iteration(vg, max_steps)
    for it in range(max_steps):
        if it and not bool(active.any()):
            break
        *new, active = line(*st, active, params, updates, value_init, slope_init, guess,
                            *extra)
        st = _Line(*new)
    return st.stepsize, st.value, st.grad


def line_iteration(vg: Callable, max_steps: int) -> Callable:
    """One iteration of :func:`zoom_linesearch`'s loop as a function of
    tensors alone, for :class:`~bio_ik_tpu_torch.graphs.Replay` to capture:
    ``(*state, active, params, updates, value_init, slope_init, guess,
    *extra) → (*state, active)`` with ``vg(x, *extra)``; the active rows
    step, the others keep their state."""
    n = len(_Line._fields)

    def run(*t):
        st = _Line(*t[:n])
        active, params, updates, value_init, slope_init, guess = t[n:n + 6]
        extra = t[n + 6:]
        new = _select(active, _line_step(st, lambda x: vg(x, *extra), params, updates,
                                         value_init, slope_init, guess, max_steps), st)
        return (*new, ~(new.done | new.failed))

    return run


def _line_step(st: _Line, vg, params, updates, value_init, slope_init, guess,
               max_steps) -> _Line:
    """One iteration of every row: ``_search_interval`` where no interval is
    found yet, else ``_zoom_into_interval`` (optax linesearch.py:815, :971),
    then ``_try_safe_step`` (:768) where the row failed.  Both phases share
    the one evaluation at the stepsize their row asks for."""
    it = st.count
    # the zoom's trial point (optax :1000-1029)
    low, high = st.low, st.high
    delta = torch.abs(high - low)
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
    too_small_int = delta <= _STEPSIZE_PRECISION
    mc = _cubicmin(low, st.value_low, st.slope_low, high, st.value_high, st.cubic_ref,
                   st.value_cubic_ref)
    use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
    mq = _quadmin(low, st.value_low, st.slope_low, high, st.value_high)
    use_quad = ~use_cubic & (mq > left + quad_chk) & (mq < right - quad_chk)
    use_bis = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, mc, st.cubic_ref)
    middle = torch.where(use_quad, mq, middle)
    middle = torch.where(use_bis, (low + high) / 2.0, middle)
    # the interval search's trial point (optax :856-863)
    trial = torch.where(it == 0, guess, _INCREASE * st.stepsize)

    t = torch.where(st.interval_found, middle, trial)
    v, g = vg(params + t[..., None] * updates)
    s = _vdot(g, updates)
    de = _decrease_error(t, v, s, value_init, slope_init)
    ce = _curvature_error(s, slope_init)
    err = torch.maximum(de, ce)
    safe_decrease = de <= _TOL
    done = err <= _TOL
    last = it + 1 >= max_steps

    # _search_interval (optax :815-969)
    high_new = (de > 0.0) | ((v >= st.value) & (it > 0))
    low_new = (s >= 0.0) & ~high_new
    S_low = torch.where(low_new, t, st.stepsize)
    S_vlow = torch.where(low_new, v, st.value)
    S_slow = torch.where(low_new, s, st.slope)
    S_high = torch.where(low_new, st.stepsize, t)
    S_vhigh = torch.where(low_new, st.value, v)
    S_shigh = torch.where(low_new, st.slope, s)
    search = _Line(
        count=it + 1, stepsize=t, value=v, grad=g, slope=s, decrease_error=de,
        curvature_error=ce, interval_found=high_new | low_new | done, done=done,
        failed=last & ~done, low=S_low, value_low=S_vlow, slope_low=S_slow,
        high=S_high, value_high=S_vhigh, slope_high=S_shigh, cubic_ref=S_low,
        value_cubic_ref=S_vlow,
        safe_stepsize=torch.where(safe_decrease, t, st.safe_stepsize),
        safe_value=torch.where(safe_decrease, v, st.safe_value),
        safe_grad=torch.where(safe_decrease[..., None], g, st.safe_grad))

    # _zoom_into_interval (optax :971-1161)
    upd_safe = safe_decrease & (v < st.safe_value)
    z_safe = torch.where(upd_safe, t, st.safe_stepsize)
    h_mid = (de > 0.0) | (v >= st.value_low)
    h_low = (s * (high - low) >= 0.0) & ~h_mid
    l_mid = ~h_mid
    Z_high = torch.where(h_low, low, torch.where(h_mid, t, high))
    Z_vhigh = torch.where(h_low, st.value_low, torch.where(h_mid, v, st.value_high))
    Z_shigh = torch.where(h_low, st.slope_low, torch.where(h_mid, s, st.slope_high))
    to_high = h_mid | h_low
    zoom = _Line(
        count=it + 1, stepsize=t, value=v, grad=g, slope=s, decrease_error=de,
        curvature_error=ce, interval_found=st.interval_found, done=done,
        failed=(last | (too_small_int & (z_safe > 0.0))) & ~done,
        low=torch.where(l_mid, t, low), value_low=torch.where(l_mid, v, st.value_low),
        slope_low=torch.where(l_mid, s, st.slope_low),
        high=Z_high, value_high=Z_vhigh, slope_high=Z_shigh,
        cubic_ref=torch.where(to_high, high, low),
        value_cubic_ref=torch.where(to_high, st.value_high, st.value_low),
        safe_stepsize=z_safe, safe_value=torch.where(upd_safe, v, st.safe_value),
        safe_grad=torch.where(upd_safe[..., None], g, st.safe_grad))

    new = _select(st.interval_found, zoom, search)
    # _try_safe_step where the row failed: the last point of sufficient
    # decrease, or the safe point (stepsize 0) outside the domain
    take = new.failed & ((new.safe_stepsize > 0.0) | torch.isinf(new.decrease_error))
    return new._replace(
        stepsize=torch.where(take, new.safe_stepsize, new.stepsize),
        value=torch.where(take, new.safe_value, new.value),
        grad=torch.where(take[..., None], new.safe_grad, new.grad))


# --------------------------------------------------------------------------
# the composed optimizers


class QuasiNewtonState(NamedTuple):
    lbfgs: Optional[LbfgsState]   # None for gradient descent
    zoom: ZoomState


class QuasiNewton:
    """``optax.lbfgs(memory_size=memory)`` (``scale_by_lbfgs`` → ``scale(-1)``
    → zoom line search with 20 steps and the guess 1 each update), or with
    ``memory=None`` ``optax.chain(optax.sgd(1.0),
    optax.scale_by_zoom_linesearch(max_linesearch_steps))`` (the guess:
    the last stepsize, ``'keep'``)."""

    def __init__(self, memory: Optional[int] = 10, max_linesearch_steps: int = 20):
        self.memory = memory
        self.max_steps = max_linesearch_steps

    def init(self, params) -> QuasiNewtonState:
        lb = None if self.memory is None else _lbfgs_init(params, self.memory)
        return QuasiNewtonState(lbfgs=lb, zoom=_zoom_init(params))

    def update(self, vg: Callable, params, st: QuasiNewtonState, extra=(),
               line: Optional[Callable] = None):
        """One update of every row on the objective whose value and gradient
        ``vg(x (..., V), *extra) → ((...), (..., V))`` gives
        (:func:`value_and_grad`, or its replay): the value and gradient
        stored by the last line search where finite
        (``optax.value_and_grad_from_state``), else evaluated; the
        direction; the line search (``line``: :func:`line_iteration` of
        ``vg``, or its replay); → ``(params, state)``."""
        stored = torch.isfinite(st.zoom.value)
        if bool(stored.all()):
            value, grad = st.zoom.value, st.zoom.grad
        else:
            v, g = vg(params, *extra)
            value = torch.where(stored, st.zoom.value, v)
            grad = torch.where(stored[..., None], st.zoom.grad, g)
        lb = st.lbfgs
        if lb is None:
            direction, guess = grad, st.zoom.learning_rate
        else:
            direction, lb = _lbfgs_update(grad, lb, params)
            guess = torch.ones_like(value)
        updates = -1.0 * direction
        step, value, grad = zoom_linesearch(vg, params, updates, value, grad, guess,
                                            self.max_steps, extra, line)
        params = params + step[..., None] * updates
        return params, QuasiNewtonState(lbfgs=lb, zoom=ZoomState(step, value, grad))

