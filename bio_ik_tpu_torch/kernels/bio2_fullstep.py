"""One fused bio2 step over ``(rows, N)`` lane rows, plain torch.

Port of :mod:`bio_ik_tpu.kernels.bio2_fullstep` for the pose family
(position/orientation/pose goals folded through the weight rows): exact FK
and delta-frame linearization at parent 0, ``gens`` generations of mutate
→ clip → momentum mix → linearized fitness → first-min select of 2 of
C+2, ``mem_iters`` memetic line-search iterations, then exact FK and the
species fitness at the new parent 0 (reference: ik_evolution_2.cpp:
328-614).  This is the reference the CUDA megastep kernel
(``csrc/megastep.cu``) is held to; the kernel inlines the same step.

Randomness.  The TPU kernel drew from the core's hardware PRNG; the port
uses counter-based Philox4x32-10, written once here in int64 torch
arithmetic and once in the CUDA kernel, so both produce the same bits for
the same (seed, lane, step, generation, draw) counter.  As in the
reference, each lane's salt is XORed into every raw 32-bit word.  How the
megastep and species kernels map words to draws is
``bio2_megastep.philox_draw``: their CLT4 Gaussians come from
:func:`packed_fields` and :func:`clt4_from_fields`, their rates from
:func:`rates_from_words`.

With joint-space secondary goals (``sec_terms``) the step ranks each
generation's children by secondary fitness and keeps a random-count best
prefix, and the memetic line search runs on the combined fitness while
accepting on the primary (reference :366-378, :459-537).

Besides the pose family (position/orientation/pose folded through the
weight rows) the step evaluates the eight other kinds of the JAX body
(lookat, line, plane, max_distance, min_distance, cone, direction, side;
``inst_kind``), reading the per-instance rows as ``engine._goal_rows``
packs them: the extra ``gaux (3K, N)`` rows carry a link-local axis or a
line direction / plane normal (:data:`AUX_KINDS`), ``wrot`` the distance of
max/min_distance and the position weight of cone, cone's free ``gquat``
rows its [direction, angle].  Their memetic gradient has the position
columns only, as in the JAX body.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .bio2_step import SpeciesParams, _P, make_sec_eval, preselect
from .fk_rows import FkRows, _qrot

__all__ = ["make_fullstep_inner", "array_draw_gen", "gauss_from_u01",
           "philox4x32", "philox_words", "u01_from_bits", "rate_from_bits",
           "packed_fields", "clt4_from_fields", "rates_from_words",
           "GAUSS_MODES", "POSE_KINDS", "AUX_KINDS", "LINK_KINDS"]

GAUSS_MODES = ("clt4", "box_muller")
POSE_KINDS = ("position", "orientation", "pose")
# the other kinds of the step, in the order of their kernel codes
# (csrc/megastep.cuh GK_*; the pose family is code 0)
LINK_KINDS = ("lookat", "line", "plane", "max_distance", "min_distance",
              "cone", "direction", "side")
# kinds whose rows need the extra gaux (3K, N) const: the link-local axis
# (lookat/direction/side/cone) or the line direction / plane normal
AUX_KINDS = ("lookat", "line", "plane", "direction", "side", "cone")

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_INV24 = 1.0 / (1 << 24)
_SQRT3 = float(np.float32(np.sqrt(3.0)))
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of ``a·b`` for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values: the 64-bit product, which int64
    arithmetic keeps modulo 2^64 (two's complement), split in two."""
    p = b * a
    return (p >> 32) & _M32, p & _M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    uint32 words; the same function as ``philox4x32`` in csrc/megastep.cu."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seed: int, lane, step: int, gen, idx, salt):
    """The four salted 32-bit words of counter ``(lane, step, gen, idx)``
    under key ``(seed, 0)``; ``lane``/``idx``/``salt`` (and ``gen``, an int
    or a tensor) broadcast as int64 tensors, ``salt`` XORed into every
    word."""
    # the counter words broadcast as the rounds mix them: the first rounds
    # run on the narrow shapes
    gen = torch.as_tensor(gen, dtype=torch.int64, device=lane.device) & _M32
    c1 = torch.as_tensor(step & _M32, dtype=torch.int64, device=lane.device)
    words = philox4x32(lane, c1, gen, idx, seed & _M32, 0)
    shape = torch.broadcast_tensors(lane, idx, gen)[0].shape
    return tuple((w ^ salt).expand(shape) for w in words)


def u01_from_bits(bits, lo=0.0):
    """Uniform in ``[lo, lo+1)`` from the top 24 bits (as
    ``make_rng_helpers`` in the JAX package) of 32-bit words held in int64
    or in int32 (the mask undoes int32's sign-extending shift)."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * _INV24 + lo


def rate_from_bits(bits):
    """Mutation-rate ladder 2^(k−23), k = bits & 15, built from exponent
    bits (reference: mutation_rate, ik_evolution_2.cpp:265)."""
    return (((bits & 15) + 104) << 23).to(torch.int32).view(torch.float32)


def packed_fields(words, n: int):
    """The first ``n`` 24-bit fields of a word sequence (int64 tensors of
    32-bit values) read as one little-endian bit string: four fields to
    three words, field ``f`` at bit ``24·f`` (the CUDA kernel's field24)."""
    out = []
    for f in range(n):
        i, o = divmod(24 * f, 32)
        x = words[i] >> o
        if o > 8:
            x = x | (words[i + 1] << (32 - o))
        out.append(x & 0xFFFFFF)
    return out


def clt4_from_fields(fields):
    """Irwin–Hall Gaussians ``(Σ₄ u − 2)·√3`` from four 24-bit fields
    (int64 tensors), as the CUDA megastep draws them: the fields summed
    exactly in integers (< 2²⁶), one conversion to float32, one scale.
    Within 2⁻²² of :func:`gauss_from_u01`'s float sum of the same four
    uniforms ``field·2⁻²⁴`` (that sum rounds up to three times)."""
    return (sum(fields).to(torch.float32) * _INV24 - 2.0) * _SQRT3


def rates_from_words(words, C: int):
    """The C mutation rates of a generation from one Philox call: rate c is
    :func:`rate_from_bits` of the 4-bit field c — word ``c // 8``, bits
    ``4·(c % 8)`` — of the call's words ``(x, y, z)``; ``(..., C, N)`` from
    ``(..., 1, N)`` words, C ≤ 24."""
    if C > 24:
        raise ValueError(f"{C} rates exceed the 24 fields of one call")
    w = torch.cat(list(words[:3]), -2)                        # (..., 3, N)
    c = torch.arange(C, device=w.device)
    return rate_from_bits(w[..., c // 8, :] >> (4 * (c % 8))[:, None])


def gauss_from_u01(u, gauss_mode="clt4"):
    """Unit gaussians from four (clt4) or two (Box–Muller) uniforms.

    ``clt4``: Irwin–Hall ``(Σ₄ u − 2)·√3``, transcendental-free, tails cut
    at ±3.46σ; ``box_muller``: exact normals with ``u[0] ∈ (2⁻²⁵, 1]``."""
    if gauss_mode == "clt4":
        s = u[0] + u[1] + u[2] + u[3]
        return (s - 2.0) * _SQRT3
    rad = torch.sqrt(-2.0 * torch.log(u[0]))
    return rad * torch.cos(float(np.float32(2.0 * np.pi)) * u[1])


def array_draw_gen(noise, rates, keep=None):
    """Adapt host ``noise (gens,V,C,N)`` / ``rates (gens,C,N)`` (and, with
    secondary goals, the pre-selection uniforms ``keep (gens,1,N)``) to the
    per-generation ``draw_gen`` interface of :func:`make_fullstep_inner`."""
    def draw_gen(g):
        if keep is None:
            return noise[g], rates[g]
        return noise[g], rates[g], keep[g]

    return draw_gen


def _atan2_nonneg(y, x):
    """atan2 for y ≥ 0 (range [0, π]) by the JAX body's Hastings odd
    polynomial (max error ~1e-5 rad), which the kernel repeats; the
    acceptance test evaluates the exact form."""
    ax = torch.abs(x)
    mn = torch.minimum(y, ax)
    mx = torch.maximum(y, ax)
    t = mn / (mx + 1e-30)
    t2 = t * t
    p = t * (0.9998660 + t2 * (-0.3302995 + t2 * (0.1801410 + t2 * (
        -0.0851330 + t2 * 0.0208351))))
    r = torch.where(y > ax, _HALF_PI - p, p)
    return torch.where(x < 0, _PI - r, r)


def _comp(tipcomp, d):
    pos, quat = tipcomp
    return pos[d] if d < 3 else quat[d - 3]


def _is_zero(c):
    return isinstance(c, float) and c == 0.0


def make_fullstep_inner(model, tip_links: Sequence[str],
                        active_vars: Sequence[int],
                        inst_tip: Sequence[int], sp: SpeciesParams,
                        sec_terms: Sequence[str] = (),
                        inst_kind: Sequence[str] = None):
    """Build the fused step on ``(rows, N)`` tensors.

    ``inst_tip[k]`` maps goal instance k → tip index, ``inst_kind[k]`` its
    kind (default: all of the pose family, whose weights select
    position/orientation).  Signature::

      inner(genes (2V,N), grads (2V,N), qfix (F,N), gpos (3K,N),
            gquat (4K,N), [gaux (3K,N),] wpos (K,N), wrot (K,N),
            span/cmin/cmax (V,N), draw_gen)
        → genes', grads', tips_exact (7T,N), fit (1,N)

    ``gaux`` iff an instance is of :data:`AUX_KINDS`.  ``draw_gen(g) →
    (noise (V,C,N), rates (C,N))``.  With ``sec_terms`` the packed ``sec
    (8V,N)`` rows come after ``cmax`` and ``draw_gen`` also returns the
    pre-selection uniform ``keep (1,N)``.  Returns ``(inner, F)`` with F
    the number of fixed-variable rows.
    """
    inst_kind = list(inst_kind) if inst_kind is not None else ["pose"] * sp.K
    for kind in inst_kind:
        if kind not in POSE_KINDS + LINK_KINDS:
            raise ValueError(f"goal kind {kind!r} is not one of the fused step's")
    has_aux = any(k in AUX_KINDS for k in inst_kind)
    fkr = FkRows(model, tip_links, active_vars)
    V, K, C = sp.V, sp.K, sp.C
    T = len(tip_links)
    F = len(fkr.fixed_vars)

    def row(a, i):
        return a[i : i + 1, :]

    secondary = bool(sec_terms)

    def inner(genes, grads, qfix, gpos, gquat, *rest):
        na = int(has_aux)
        gaux = rest[0] if has_aux else None
        wpos, wrot, span, cmin, cmax = rest[na:na + 5]
        rest = rest[na + 5:]
        if secondary:
            sec, draw_gen = rest
            sec_of, sec_grad = make_sec_eval(sec, V, tuple(sec_terms))
        else:
            (draw_gen,) = rest
        dt = genes.dtype
        dev = genes.device
        N = genes.shape[-1]

        p0g = [row(genes, v) for v in range(V)]
        p1g = [row(genes, V + v) for v in range(V)]
        p0r = [row(grads, v) for v in range(V)]
        p1r = [row(grads, V + v) for v in range(V)]
        x0 = list(p0g)
        fixed_rows = [row(qfix, i) for i in range(F)]
        spn = [row(span, v) for v in range(V)]
        clo = [row(cmin, v) for v in range(V)]
        chi = [row(cmax, v) for v in range(V)]

        # ---- exact FK + linearization at parent 0 (reference :341-346) --
        fr = fkr.frames(x0, fixed_rows)
        tips0 = fkr.tips(fr)
        dts = fkr.deltas(fr)

        def phen_of(dq):
            ph = []
            for k in range(K):
                t = inst_tip[k]
                for d in range(7):
                    acc = _comp(tips0[t], d)
                    for v in range(V):
                        dv = dts[v][t]
                        if dv is None:
                            continue
                        c = _comp(dv, d)
                        if _is_zero(c):
                            continue
                        acc = acc + c * dq[v]
                    ph.append(acc)
            return ph

        def eval_goals(ph, want_grad=False):
            """The instances' errors summed (fit) and, with ``want_grad``,
            d(fit)/d(ph[k·7+d]) as ``gvec`` (the float 0.0 where a kind has
            no such column: skipped).  The JAX body's forms and order."""
            fit = None
            gvec = [0.0] * (K * 7) if want_grad else None
            for k in range(K):
                kind = inst_kind[k]
                if kind in LINK_KINDS:
                    term = link_goal(k, kind, ph, gvec)
                    fit = term if fit is None else fit + term
                    continue
                perr = 0.0
                for d in range(3):
                    e = ph[k * 7 + d] - row(gpos, k * 3 + d)
                    perr = perr + e * e
                dm = 0.0
                dp = 0.0
                for d in range(4):
                    q = ph[k * 7 + 3 + d]
                    g = row(gquat, k * 4 + d)
                    dm = dm + (q - g) * (q - g)
                    dp = dp + (q + g) * (q + g)
                qerr = torch.minimum(dm, dp)
                term = row(wpos, k) * perr + row(wrot, k) * qerr
                if want_grad:
                    sgn = torch.where(dm <= dp, 1.0, -1.0).to(dt)
                    for d in range(3):
                        gvec[k * 7 + d] = 2.0 * row(wpos, k) * (
                            ph[k * 7 + d] - row(gpos, k * 3 + d))
                    for d in range(4):
                        gvec[k * 7 + 3 + d] = 2.0 * row(wrot, k) * (
                            ph[k * 7 + 3 + d] - sgn * row(gquat, k * 4 + d))
                fit = term if fit is None else fit + term
            return fit, gvec

        def link_goal(k, kind, ph, gvec):
            """The error of instance k of one of :data:`LINK_KINDS` (JAX
            bio2_fullstep.py:250-376), its position gradient into ``gvec``."""
            pos = tuple(ph[k * 7 + d] for d in range(3))
            q = tuple(ph[k * 7 + 3 + d] for d in range(4))
            gp = tuple(row(gpos, k * 3 + d) for d in range(3))
            ax = (tuple(row(gaux, k * 3 + d) for d in range(3))
                  if kind in AUX_KINDS else None)
            w = row(wpos, k)
            want = gvec is not None
            if kind == "lookat":
                # ‖normalize(target−p) − normalize(R·axis)‖²
                u = _qrot(q, ax)
                uinv = torch.rsqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + 1e-12)
                v = tuple(c * uinv for c in u)
                dx = tuple(gp[d] - pos[d] for d in range(3))
                dinv = torch.rsqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
                                   + 1e-12)
                n = tuple(c * dinv for c in dx)
                err = 0.0
                for d in range(3):
                    e = n[d] - v[d]
                    err = err + e * e
                if want:
                    s = 0.0
                    for d in range(3):
                        s = s + n[d] * (n[d] - v[d])
                    for d in range(3):
                        gvec[k * 7 + d] = w * (-2.0 * dinv) * ((n[d] - v[d]) - n[d] * s)
                return w * err
            if kind == "line":
                # ‖(p−o) − d·((p−o)·d)‖²: o in gpos, unit d in gaux
                dx = tuple(pos[d] - gp[d] for d in range(3))
                along = dx[0] * ax[0] + dx[1] * ax[1] + dx[2] * ax[2]
                perp = tuple(dx[d] - ax[d] * along for d in range(3))
                err = perp[0] * perp[0] + perp[1] * perp[1] + perp[2] * perp[2]
                if want:
                    for d in range(3):
                        gvec[k * 7 + d] = 2.0 * w * perp[d]
                return w * err
            if kind == "plane":
                # ((p−o)·n)²: o in gpos, unit n in gaux
                sd = 0.0
                for d in range(3):
                    sd = sd + (pos[d] - gp[d]) * ax[d]
                if want:
                    for d in range(3):
                        gvec[k * 7 + d] = 2.0 * w * sd * ax[d]
                return w * (sd * sd)
            if kind in ("max_distance", "min_distance"):
                # relu(±(|p−t| − dist))²: t in gpos, dist in the wrot row
                dx = tuple(pos[d] - gp[d] for d in range(3))
                nrm2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
                rinv = torch.rsqrt(nrm2 + 1e-12)
                nrm = nrm2 * rinv
                sgn = 1.0 if kind == "max_distance" else -1.0
                dd = torch.clamp(sgn * (nrm - row(wrot, k)), min=0.0)
                if want:
                    c = 2.0 * sgn * w * dd * rinv
                    for d in range(3):
                        gvec[k * 7 + d] = c * dx[d]
                return w * (dd * dd)
            if kind == "cone":
                # max(0, angle(R·axis, dir) − angle)² + pw·‖pos − p‖²: apex in
                # gpos, [dir, angle] in the gquat rows, pw in the wrot row
                v = _qrot(q, ax)
                dr = tuple(row(gquat, k * 4 + d) for d in range(3))
                cx = v[1] * dr[2] - v[2] * dr[1]
                cy = v[2] * dr[0] - v[0] * dr[2]
                cz = v[0] * dr[1] - v[1] * dr[0]
                cn = torch.sqrt(cx * cx + cy * cy + cz * cz + 1e-18)
                dot = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2]
                dd = torch.clamp(_atan2_nonneg(cn, dot) - row(gquat, k * 4 + 3), min=0.0)
                pe = 0.0
                for d in range(3):
                    e = gp[d] - pos[d]
                    pe = pe + e * e
                if want:
                    c = 2.0 * w * row(wrot, k)
                    for d in range(3):
                        gvec[k * 7 + d] = c * (pos[d] - gp[d])
                return w * (dd * dd + row(wrot, k) * pe)
            # direction ‖R·axis − dir‖², side relu(R·axis · dir)²: dir in
            # gpos; no gradient (the rotation columns are omitted)
            v = _qrot(q, ax)
            if kind == "direction":
                err = 0.0
                for d in range(3):
                    e = v[d] - gp[d]
                    err = err + e * e
            else:
                f = 0.0
                for d in range(3):
                    f = f + v[d] * gp[d]
                fr = torch.clamp(f, min=0.0)
                err = fr * fr
            return w * err

        child_global = torch.arange(C, device=dev)[:, None] + _P
        fmix = torch.where(child_global % 2 == 0, 0.2, 0.0).to(dt)
        gfac = (child_global % 3).to(dt)

        # ---- generations (reference :349-431) ---------------------------
        for g in range(sp.gens):
            if secondary:
                noise_g, rate, keep_u = draw_gen(g)
            else:
                noise_g, rate = draw_gen(g)
            pgrad = [p0r[v] * (1.0 - fmix) + p1r[v] * fmix for v in range(V)]
            cg, cr = [], []
            for v in range(V):
                gv = p0g[v] + noise_g[v] * (rate * spn[v]) + pgrad[v] * gfac
                gv = torch.clamp(gv, clo[v], chi[v])
                cg.append(gv)
                cr.append(pgrad[v] * 0.7 + (gv - p0g[v]) * 0.3)
            pool_g = [torch.cat([p0g[v], p1g[v], cg[v]], 0) for v in range(V)]
            pool_r = [torch.cat([p0r[v], p1r[v], cr[v]], 0) for v in range(V)]
            fit, _ = eval_goals(phen_of([pool_g[v] - x0[v] for v in range(V)]))
            if secondary:
                fit = preselect(fit, sec_of(cg), keep_u, C)
            # first-min select of 2 of C+2 (the JAX body's pick); kept
            # candidates are gathered, not one-hot summed, so 0·inf never
            # turns into NaN
            i1 = torch.argmin(fit, dim=0, keepdim=True)
            i2 = torch.argmin(fit.scatter(0, i1, float("inf")), dim=0,
                              keepdim=True)
            p0g = [torch.gather(pool_g[v], 0, i1) for v in range(V)]
            p1g = [torch.gather(pool_g[v], 0, i2) for v in range(V)]
            p0r = [torch.gather(pool_r[v], 0, i1) for v in range(V)]
            p1r = [torch.gather(pool_r[v], 0, i2) for v in range(V)]

        # ---- memetic on parent 0 (reference :436-600) --------------------
        if sp.memetic:
            h = sp.h
            x = list(p0g)
            done = torch.zeros((1, N), dtype=torch.bool, device=dev)
            for _ in range(sp.mem_iters):
                ph = phen_of([x[v] - x0[v] for v in range(V)])
                f2p, gvec = eval_goals(ph, want_grad=True)
                # the line search runs on the combined fitness, acceptance
                # stays primary against primary (reference :459-537)
                f2 = f2p + sec_of(x) if secondary else f2p
                grad = []
                for v in range(V):
                    gv = 0.0
                    for k in range(K):
                        t = inst_tip[k]
                        dv = dts[v][t]
                        if dv is None:
                            continue
                        for d in range(7):
                            c = _comp(dv, d)
                            if _is_zero(c):
                                continue
                            gk = gvec[k * 7 + d]
                            if _is_zero(gk):
                                continue
                            gv = gv + c * gk
                    if secondary:
                        gv = gv + sec_grad(x, v)
                    grad.append(gv)
                l1 = 0.0
                for v in range(V):
                    if _is_zero(grad[v]):
                        continue
                    l1 = l1 + torch.abs(grad[v])
                scale = h / (l1 + 1e-12)
                gdir = [(0.0 if _is_zero(grad[v]) else grad[v] * scale)
                        for v in range(V)]
                xm = [x[v] - gdir[v] for v in range(V)]
                xp = [x[v] + gdir[v] for v in range(V)]
                f1, _ = eval_goals(phen_of([xm[v] - x0[v] for v in range(V)]))
                f3, _ = eval_goals(phen_of([xp[v] - x0[v] for v in range(V)]))
                if secondary:
                    f1 = f1 + sec_of(xm)
                    f3 = f3 + sec_of(xp)
                if sp.memetic == "q":
                    v1, v2 = f2 - f1, f3 - f2
                    vv = (v1 + v2) * 0.5
                    a = v1 - v2
                    q = vv / a
                    step = torch.where(torch.isfinite(q), q, 0.0)
                    cand = [torch.clamp(x[v] + gdir[v] * step, clo[v], chi[v])
                            for v in range(V)]
                else:
                    cost_diff = (f3 - f1) * 0.5
                    q = f2 / cost_diff
                    step = torch.where(torch.isfinite(q), q, 0.0)
                    cand = [torch.clamp(x[v] - gdir[v] * step, clo[v], chi[v])
                            for v in range(V)]
                f4, _ = eval_goals(phen_of([cand[v] - x0[v] for v in range(V)]))
                accept = (f4 < f2p) & ~done
                x = [torch.where(accept, cand[v], x[v]) for v in range(V)]
                done = done | ~accept
            p0g = x

        # ---- exact FK + species fitness at the new parent 0 -------------
        tips2 = fkr.tips(fkr.frames(p0g, fixed_rows))
        ph_exact = [_comp(tips2[inst_tip[k]], d)
                    for k in range(K) for d in range(7)]
        ph_exact = [c if torch.is_tensor(c)
                    else torch.full((1, N), c, dtype=dt, device=dev)
                    for c in ph_exact]
        fit_exact, _ = eval_goals(ph_exact)
        tip_rows = []
        for t in range(T):
            for d in range(7):
                c = _comp(tips2[t], d)
                if not torch.is_tensor(c):
                    c = torch.full((1, N), c, dtype=dt, device=dev)
                tip_rows.append(c)
        return (torch.cat(p0g + p1g, 0), torch.cat(p0r + p1r, 0),
                torch.cat(tip_rows, 0), fit_exact)

    return inner, F
