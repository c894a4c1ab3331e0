"""Megastep: many fused bio2 steps — species sort, wipeout and incumbent
tracking included — in one launch.

Port of :mod:`bio_ik_tpu.kernels.bio2_megastep`.  :func:`make_megastep_body`
is the plain torch version (eager, over ``(rows, N)`` tensors);
:class:`Megastep` is the wrapper a caller uses: on CUDA tensors it launches
the hand-written kernel of ``csrc/megastep.cu``, on CPU tensors it runs the
plain version.  There is no fallback between the two.

Species pairing rides the lane layout ``lane = ((b·I + i)·S + s)`` with
S = 2 species fastest, so the two species of an island are adjacent lanes
and the compare-swap (reference: ik_evolution_2.cpp:617) exchanges lane
pairs (``torch.roll`` here, a warp shuffle in the kernel).  The incumbent
is tracked per lane; the engine reduces over lanes at chunk boundaries.

Two randomness modes, in both versions:
  * noise tensors — ``noise (steps·gens, V, C, N)``, ``rates (steps·gens,
    C, N)``, ``wipe_u (steps, 1, N)``, ``wipe_g (steps, V, N)`` from the
    caller; the mode in which the kernel is compared with the plain version
    and the JAX body;
  * in-kernel Philox (seed + per-lane salt), the mode of the solve.  The
    plain version draws the identical bits (:func:`philox_draw`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .bio2_fullstep import (
    GAUSS_MODES,
    array_draw_gen,
    gauss_from_u01,
    make_fullstep_inner,
    philox_words,
    rate_from_bits,
    u01_from_bits,
)
from .bio2_step import SpeciesParams, _P
from .fk_rows import FkRows

__all__ = ["make_megastep_body", "array_draw", "philox_draw", "Megastep",
           "megastep_flops_per_lane"]

_WIPEOUT_P = 0.1  # reference: ik_evolution_2.cpp:632
_WIPE_GEN = 0xFFFFFFFF  # Philox generation word of a step's wipeout draws
_MEMETIC_CODE = {"": 0, "q": 1, "l": 2}
_RNG_CODE = {None: 0, "clt4": 1, "box_muller": 2}


def megastep_flops_per_lane(sp: SpeciesParams, n_steps: int) -> int:
    """FLOPs per lane per launch, as the TPU kernel's cost estimate counts
    them (bio2_megastep.py:309-310): ``evals·(14KV + 30K) + 900`` per step
    with ``evals = gens·(C+2) + 4·mem_iters``.  Leaves out sin/cos, RNG and
    selection."""
    evals = sp.gens * (sp.C + _P) + (sp.mem_iters * 4 if sp.memetic else 0)
    return n_steps * (evals * (sp.K * 7 * sp.V * 2 + sp.K * 30) + 900)


def make_megastep_body(model, tip_links, active_vars, inst_tip,
                       sp: SpeciesParams, n_steps: int, inst_kind=None):
    """Build the chunk body over ``(rows, N)`` tensors.

    Returns ``(body, F)``; ``body(state, consts, draw)`` advances

      state  = (genes (2V,N), grads (2V,N), sfit (1,N),
                sol (V,N), sol_fit (1,N), sol_tips (7T,N))
      consts = (qfix (max(F,1),N), gpos (3K,N), gquat (4K,N), wpos (K,N),
                wrot (K,N), span/cmin/cmax/amin/amax (V,N))

    by ``n_steps`` fused steps; ``draw(i) → (draw_gen, wipe_u (1,N),
    wipe_g (V,N))`` supplies step i's randomness.
    """
    inner, F = make_fullstep_inner(model, tip_links, active_vars, inst_tip,
                                   sp, inst_kind=inst_kind)
    V = sp.V

    def body(state, consts, draw):
        genes, grads, sfit, sol, sol_fit, sol_tips = state
        qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, amin, amax = consts
        N = genes.shape[-1]
        even = (torch.arange(N, device=genes.device) % 2 == 0)[None, :]

        def partner(x):
            """The paired-species lane values (adjacent-lane exchange)."""
            return torch.where(even, torch.roll(x, -1, -1), torch.roll(x, 1, -1))

        for i in range(n_steps):
            draw_gen, wipe_u, wipe_g = draw(i)
            genes, grads, tips, fit = inner(
                genes, grads, qfix, gpos, gquat, wpos, wrot, span, cmin,
                cmax, draw_gen)

            # per-lane incumbent update (reference :640-644)
            better = fit < sol_fit
            sol = torch.where(better, genes[:V], sol)
            sol_tips = torch.where(better, tips, sol_tips)
            sol_fit = torch.where(better, fit, sol_fit)

            improved = fit != sfit

            # species compare-swap between adjacent lanes (reference :617)
            fp = partner(fit)
            swap = (even & (fp < fit)) | (~even & (fit < fp))
            genes = torch.where(swap, partner(genes), genes)
            grads = torch.where(swap, partner(grads), grads)
            improved = torch.where(swap, partner(improved), improved)
            fit = torch.where(swap, fp, fit)

            # wipeout of the odd (non-best) species (reference :620-637)
            wipe = ~even & ((wipe_u < _WIPEOUT_P) | ~improved)
            rand = amin + wipe_g * (amax - amin)
            genes = torch.where(wipe, torch.cat([rand, rand], 0), genes)
            grads = torch.where(wipe, torch.zeros_like(grads), grads)
            sfit = fit
        return genes, grads, sfit, sol, sol_fit, sol_tips

    return body, F


def array_draw(noise, rates, wipe_u, wipe_g, gens: int):
    """``draw(i)`` over caller-provided noise tensors (noise-tensor mode)."""
    def draw(i):
        g0 = i * gens
        return (array_draw_gen(noise[g0:g0 + gens], rates[g0:g0 + gens]),
                wipe_u[i], wipe_g[i])

    return draw


def philox_draw(seed: int, salt, V: int, C: int, gauss_mode: str = "clt4"):
    """``draw(i)`` from the Philox stream the CUDA kernel draws in-kernel:
    counter ``(lane, step i, generation g, draw)`` under key ``(seed, 0)``;
    gaussian (v, c) is draw ``v·C + c`` (its four words feed clt4, the
    first two Box–Muller), rate c is draw ``V·C + c``; the wipe coin and
    restart genes are draws ``0`` and ``1 + v`` of generation word
    ``0xFFFFFFFF``.  ``salt`` is the ``(1, N)`` int32 per-lane salt."""
    if gauss_mode not in GAUSS_MODES:
        raise ValueError(f"gauss_mode must be one of {GAUSS_MODES}")
    dev = salt.device
    salt64 = salt.to(torch.int64) & 0xFFFFFFFF
    N = salt.shape[-1]
    lane = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    gidx = torch.arange(V * C, device=dev, dtype=torch.int64)[:, None]
    ridx = torch.arange(C, device=dev, dtype=torch.int64)[:, None] + V * C
    widx = torch.arange(1 + V, device=dev, dtype=torch.int64)[:, None]

    def draw(i):
        def draw_gen(g):
            w = philox_words(seed, lane, i, g, gidx, salt64)
            if gauss_mode == "clt4":
                u = [u01_from_bits(x) for x in w]
            else:
                u = [u01_from_bits(w[0], lo=2.0 ** -25), u01_from_bits(w[1])]
            noise = gauss_from_u01(u, gauss_mode).view(V, C, N)
            rates = rate_from_bits(
                philox_words(seed, lane, i, g, ridx, salt64)[0])
            return noise, rates

        w = u01_from_bits(philox_words(seed, lane, i, _WIPE_GEN, widx, salt64)[0])
        return draw_gen, w[0:1], w[1:]

    return draw


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


class Megastep:
    """The megastep for one (model, tips, active set, goal instances,
    species params, n_steps); call it on the solver state.

    ``Megastep.launches`` counts kernel launches over all instances; it is
    incremented only where the CUDA kernel is launched.
    """

    launches = 0

    def __init__(self, model, tip_links, active_vars, inst_tip,
                 sp: SpeciesParams, n_steps: int, gauss_mode: str = "clt4",
                 inst_kind=None):
        if gauss_mode not in GAUSS_MODES:
            raise ValueError(f"gauss_mode must be one of {GAUSS_MODES}")
        self.sp, self.n_steps, self.gauss_mode = sp, n_steps, gauss_mode
        self.body, self.F = make_megastep_body(
            model, tip_links, active_vars, inst_tip, sp, n_steps,
            inst_kind=inst_kind)
        self.T = len(tip_links)
        link_i, link_f, tip_slot = FkRows(
            model, tip_links, active_vars).chain_arrays()
        self._chain = (link_i, link_f, tip_slot,
                       np.asarray(inst_tip, np.int32))
        self._chain_dev = {}
        self.state_rows = [_P * sp.V, _P * sp.V, 1, sp.V, 1, 7 * self.T]
        self.const_rows = [max(self.F, 1), 3 * sp.K, 4 * sp.K, sp.K, sp.K,
                           sp.V, sp.V, sp.V, sp.V, sp.V]

    def __call__(self, state, consts, *, seed=None, salt=None, noise=None,
                 rates=None, wipe_u=None, wipe_g=None):
        """Advance ``state`` by ``n_steps`` steps.  Either ``seed`` (int) and
        ``salt`` ((1, N) int32) for in-kernel Philox, or the four noise
        tensors.  Returns the new state tuple."""
        tensors = noise is not None
        if not tensors and (seed is None or salt is None):
            raise ValueError("pass seed and salt, or the noise tensors")
        dev = state[0].device
        if dev.type == "cpu":
            sp = self.sp
            if tensors:
                draw = array_draw(noise, rates, wipe_u, wipe_g, sp.gens)
            else:
                draw = philox_draw(int(seed), salt, sp.V, sp.C, self.gauss_mode)
            return self.body(tuple(state), tuple(consts), draw)
        if dev.type == "cuda":
            return self._launch(state, consts, seed, salt,
                                (noise, rates, wipe_u, wipe_g) if tensors else None)
        raise ValueError(f"megastep runs on cuda or cpu tensors, not {dev}")

    # ------------------------------------------------------------------
    def _launch(self, state, consts, seed, salt, rng):
        from .build import load

        lib = load("megastep")
        sp = self.sp
        genes = state[0]
        dev = genes.device
        N = genes.shape[-1]
        if N % 2:
            raise ValueError(f"lane count {N} must be even (species pairs)")
        lib.megastep_has_shape.argtypes = [ctypes.c_int] * 3
        lib.megastep_has_shape.restype = ctypes.c_int
        if not lib.megastep_has_shape(sp.V, sp.K, self.T):
            raise ValueError(
                f"the megastep kernel is not instantiated for V={sp.V}, "
                f"K={sp.K}, T={self.T} (SHAPES in csrc/megastep.cu)")

        def check(t, rows, name, dtype=torch.float32):
            if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                    or tuple(t.shape) != (rows, N):
                raise ValueError(
                    f"{name}: want a contiguous {dtype} ({rows}, {N}) tensor "
                    f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")

        for t, r, nm in zip(state, self.state_rows,
                            ("genes", "grads", "sfit", "sol", "sol_fit",
                             "sol_tips")):
            check(t, r, nm)
        for t, r, nm in zip(consts, self.const_rows,
                            ("qfix", "gpos", "gquat", "wpos", "wrot", "span",
                             "cmin", "cmax", "amin", "amax")):
            check(t, r, nm)
        steps_gens = self.n_steps * sp.gens
        if rng is None:
            check(salt, 1, "salt", torch.int32)
            rng_mode = _RNG_CODE[self.gauss_mode]
            noise = rates = wipe_u = wipe_g = genes   # unread
        else:
            noise, rates, wipe_u, wipe_g = rng
            for t, shape, nm in ((noise, (steps_gens, sp.V, sp.C, N), "noise"),
                                 (rates, (steps_gens, sp.C, N), "rates"),
                                 (wipe_u, (self.n_steps, 1, N), "wipe_u"),
                                 (wipe_g, (self.n_steps, sp.V, N), "wipe_g")):
                if t.device != dev or t.dtype != torch.float32 or \
                        not t.is_contiguous() or tuple(t.shape) != shape:
                    raise ValueError(f"{nm}: want a contiguous float32 "
                                     f"{shape} tensor on {dev}")
            salt = torch.zeros((1, N), dtype=torch.int32, device=dev)
            seed = 0
            rng_mode = 0
        if dev not in self._chain_dev:
            self._chain_dev[dev] = tuple(torch.as_tensor(a, device=dev)
                                         for a in self._chain)
        chain_i, chain_f, tip_slot, inst_tip = self._chain_dev[dev]
        out = tuple(torch.empty_like(t) for t in state)
        fn = lib.megastep_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_uint]
                       + [ctypes.c_void_p] * 32)
        rc = fn(sp.V, sp.K, self.T, N, chain_i.shape[0], self.n_steps,
                sp.gens, sp.C, sp.mem_iters, _MEMETIC_CODE[sp.memetic],
                sp.h, rng_mode, int(seed) & 0xFFFFFFFF, _ptr(salt),
                *(_ptr(t) for t in state), *(_ptr(t) for t in out),
                *(_ptr(t) for t in consts),
                _ptr(noise), _ptr(rates), _ptr(wipe_u), _ptr(wipe_g),
                _ptr(chain_i), _ptr(chain_f), _ptr(tip_slot), _ptr(inst_tip),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"megastep launch failed: CUDA error {rc}")
        Megastep.launches += 1
        return out
