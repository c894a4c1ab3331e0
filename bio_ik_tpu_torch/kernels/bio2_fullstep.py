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
reference, each lane's salt is XORed into every raw 32-bit word.

The non-pose goal kinds and the secondary pre-selection of the JAX body
are not ported yet (ROADMAP.md, port queue item 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .bio2_step import SpeciesParams, _P
from .fk_rows import FkRows

__all__ = ["make_fullstep_inner", "array_draw_gen", "gauss_from_u01",
           "philox4x32", "philox_words", "u01_from_bits", "rate_from_bits",
           "GAUSS_MODES", "POSE_KINDS"]

GAUSS_MODES = ("clt4", "box_muller")
POSE_KINDS = ("position", "orientation", "pose")

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_INV24 = 1.0 / (1 << 24)
_SQRT3 = float(np.float32(np.sqrt(3.0)))


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of ``a·b`` for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values, exact in int64 (16-bit split)."""
    lo_part = (a & 0xFFFF) * b            # < 2^48
    hi_part = (a >> 16) * b               # < 2^48
    mid = hi_part + (lo_part >> 16)
    hi = (mid >> 16) & _M32
    lo = ((mid & 0xFFFF) << 16) | (lo_part & 0xFFFF)
    return hi, lo


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


def philox_words(seed: int, lane, step: int, gen: int, idx, salt):
    """The four salted 32-bit words of counter ``(lane, step, gen, idx)``
    under key ``(seed, 0)``; ``lane``/``idx``/``salt`` broadcast as int64
    tensors, ``salt`` XORed into every word."""
    lane, idx = torch.broadcast_tensors(lane, idx)
    c1 = torch.full_like(lane, step & _M32)
    c2 = torch.full_like(lane, gen & _M32)
    words = philox4x32(lane, c1, c2, idx, seed & _M32, 0)
    return tuple(w ^ salt for w in words)


def u01_from_bits(bits, lo=0.0):
    """Uniform in ``[lo, lo+1)`` from the top 24 bits (as
    ``make_rng_helpers`` in the JAX package) of 32-bit words held in int64
    or in int32 (the mask undoes int32's sign-extending shift)."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * _INV24 + lo


def rate_from_bits(bits):
    """Mutation-rate ladder 2^(k−23), k = bits & 15, built from exponent
    bits (reference: mutation_rate, ik_evolution_2.cpp:265)."""
    return (((bits & 15) + 104) << 23).to(torch.int32).view(torch.float32)


def gauss_from_u01(u, gauss_mode="clt4"):
    """Unit gaussians from four (clt4) or two (Box–Muller) uniforms.

    ``clt4``: Irwin–Hall ``(Σ₄ u − 2)·√3``, transcendental-free, tails cut
    at ±3.46σ; ``box_muller``: exact normals with ``u[0] ∈ (2⁻²⁵, 1]``."""
    if gauss_mode == "clt4":
        s = u[0] + u[1] + u[2] + u[3]
        return (s - 2.0) * _SQRT3
    rad = torch.sqrt(-2.0 * torch.log(u[0]))
    return rad * torch.cos(float(np.float32(2.0 * np.pi)) * u[1])


def array_draw_gen(noise, rates):
    """Adapt host ``noise (gens,V,C,N)`` / ``rates (gens,C,N)`` to the
    per-generation ``draw_gen`` interface of :func:`make_fullstep_inner`."""
    def draw_gen(g):
        return noise[g], rates[g]

    return draw_gen


def _comp(tipcomp, d):
    pos, quat = tipcomp
    return pos[d] if d < 3 else quat[d - 3]


def _is_zero(c):
    return isinstance(c, float) and c == 0.0


def make_fullstep_inner(model, tip_links: Sequence[str],
                        active_vars: Sequence[int],
                        inst_tip: Sequence[int], sp: SpeciesParams,
                        inst_kind: Sequence[str] = None):
    """Build the fused step on ``(rows, N)`` tensors.

    ``inst_tip[k]`` maps goal instance k → tip index; every instance is of
    the pose family (weights select position/orientation).  Signature::

      inner(genes (2V,N), grads (2V,N), qfix (F,N), gpos (3K,N),
            gquat (4K,N), wpos (K,N), wrot (K,N), span/cmin/cmax (V,N),
            draw_gen) → genes', grads', tips_exact (7T,N), fit (1,N)

    ``draw_gen(g) → (noise (V,C,N), rates (C,N))``.  Returns ``(inner,
    F)`` with F the number of fixed-variable rows.
    """
    if inst_kind is not None and any(k not in POSE_KINDS for k in inst_kind):
        raise NotImplementedError(
            "non-pose goal kinds in the fused step are not ported yet "
            "(ROADMAP.md, port queue item 1)")
    fkr = FkRows(model, tip_links, active_vars)
    V, K, C = sp.V, sp.K, sp.C
    T = len(tip_links)
    F = len(fkr.fixed_vars)

    def row(a, i):
        return a[i : i + 1, :]

    def inner(genes, grads, qfix, gpos, gquat, wpos, wrot, span, cmin, cmax,
              draw_gen):
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
            fit = None
            gvec = [0.0] * (K * 7) if want_grad else None
            for k in range(K):
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

        child_global = torch.arange(C, device=dev)[:, None] + _P
        fmix = torch.where(child_global % 2 == 0, 0.2, 0.0).to(dt)
        gfac = (child_global % 3).to(dt)

        # ---- generations (reference :349-431) ---------------------------
        for g in range(sp.gens):
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
                f2 = f2p
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
