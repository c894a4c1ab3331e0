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

On the card a lane runs on a group of threads: in the narrow layout its
children are split over G threads (:func:`choose_group`), in the wide one
its whole step over W threads (:func:`choose_width`), each chosen from the
lane count and the kernel's occupancy; the draws, and so the results, do
not depend on G or W.

With joint-space secondary goals (``sec_terms``) the consts end with the
packed ``sec (8V, N)`` rows and each generation draws one more uniform, the
pre-selection keep (``keep (steps·gens, 1, N)`` in noise-tensor mode).
Goal instances of the other kinds (``inst_kind``: lookat, line, plane, …;
:data:`bio2_fullstep.LINK_KINDS`) bring the ``gaux (3K, N)`` const after
``gquat`` where one of them needs it (:data:`bio2_fullstep.AUX_KINDS`).

Two layouts of the step: ``csrc/megastep.cu`` holds the pose-family
instances of few variables, a lane on one thread with its linearization in
registers (``csrc/megastep.cuh``); ``csrc/megastep_wide.cu`` (the PR2 dual
arm) and ``csrc/megastep_high.cu`` (snake-32, the 30-DOF humanoid) the
instances of many variables and tips, which evaluate every goal kind, a
lane on a group of W threads with its vectors, its linearization by
dependency column and its frames in shared memory (``csrc/megastep_wide.cuh``;
:data:`MEGASTEP_SOURCES`).  Any other (V, K, T), and a narrow shape
with a goal kind outside the pose family, gets an instance of the wide
layout generated and built on its first use (:func:`megastep_instance`,
``kernels/build.generate``): one ``nvcc`` per shape, cached under
``build/kernels``.

:class:`Fullstep` wraps the same step without the bookkeeping (the TPU
kernel ``make_fullstep_kernel``): one bio2 step, a second entry point of
``csrc/megastep.cu``.  No solve path launches it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .bio2_fullstep import (
    AUX_KINDS,
    GAUSS_MODES,
    LINK_KINDS,
    POSE_KINDS,
    array_draw_gen,
    clt4_from_fields,
    gauss_from_u01,
    make_fullstep_inner,
    packed_fields,
    philox_words,
    rates_from_words,
    u01_from_bits,
)
from .bio2_step import SMEM_OPTIN, SpeciesParams, _P, sec_term_mask
from .fk_rows import FkRows

__all__ = ["make_megastep_body", "array_draw", "philox_draw", "philox_wipe",
           "Megastep", "Fullstep", "megastep_flops_per_lane", "fullstep_bytes_per_lane",
           "philox_calls_per_lane_step", "clt4_calls", "choose_group", "choose_width",
           "wide_widths",
           "MEGASTEP_SOURCES", "MEGASTEP_GROUPS", "KIND_CODE", "dependency_columns",
           "MegastepInstance", "megastep_instance", "megastep_smem_bytes"]

# (V, K, T) instances of each megastep source (its SHAPES macro), each for
# every group size of the source's GROUPS macro: G threads a lane's
# children in the narrow source, W threads a lane in the wide layout (the
# wide and high-DOF sources, whose instances evaluate every goal kind of
# the step; :func:`wide_widths`)
MEGASTEP_SOURCES = {"megastep": ((7, 1, 1), (6, 1, 1)),
                    "megastep_wide": ((17, 2, 2),),
                    "megastep_high": ((32, 1, 1), (30, 3, 3))}
MEGASTEP_GROUPS = {"megastep": (1, 2, 4, 8), "megastep_wide": (4, 8, 16),
                   "megastep_high": (8, 16)}
# the widths W a generated instance of the wide layout builds: those of the
# high-DOF source from GEN_HIGH_V variables on, of the wide source from
# GEN_MID_V, else GEN_GROUPS (wide_widths; each the fastest there on an
# H100, PERF.md §6)
GEN_GROUPS, GEN_MID_V, GEN_HIGH_V = (4, 8), 12, 24
# the kernel's code of each goal kind (csrc/megastep.cuh GK_*)
KIND_CODE = {**dict.fromkeys(POSE_KINDS, 0),
             **{k: i + 1 for i, k in enumerate(LINK_KINDS)}}
_BLOCK = 128          # threads per block (csrc/megastep.cuh BLOCK)
_MAX_C = 16           # children per generation the kernel takes (MAX_C)
# share of a G = 1 lane-step that every thread of a group repeats (the FK,
# the memetic search, the bookkeeping): 0.26 from the pose-only kernel's
# phase-1 times at G = 1 and 2 on an H100 (PERF.md §6)
_REPEATED = 0.26
# the wide layout's lane-step latency, a full card's worth of lanes in
# flight, is this many times longer at W than at 2W (1.3–1.75 over the
# paths' first launches on an H100, PERF.md §6)
_WIDE_HALVING = 1.5

_LINK_I, _LINK_F = 7, 19   # ints and floats per link of the table (LINK_I, LINK_F)

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


def clt4_calls(V: int) -> int:
    """Philox calls of a child's V CLT4 Gaussians: 4V 24-bit fields, four to
    three words — ceil(3V/4)."""
    return (3 * V + 3) // 4


def philox_calls_per_lane_step(sp: SpeciesParams) -> int:
    """Philox4x32-10 calls of one lane-step in the kernel's clt4 mode:
    ceil(3V/4) per child, one for a generation's rates (and keep),
    ceil((V+1)/4) for the wipeout — 778 at V = 7, C = 16, gens = 8."""
    return sp.gens * (sp.C * clt4_calls(sp.V) + 1) + (sp.V + 4) // 4


def wide_widths(V: int) -> tuple:
    """The group widths W a generated instance of the wide layout builds at
    ``V`` variables: the high-DOF source's from :data:`GEN_HIGH_V`, the wide
    source's from :data:`GEN_MID_V`, else :data:`GEN_GROUPS`."""
    return (MEGASTEP_GROUPS["megastep_high"] if V >= GEN_HIGH_V else
            MEGASTEP_GROUPS["megastep_wide"] if V >= GEN_MID_V else GEN_GROUPS)


def choose_width(N: int, resident) -> int:
    """The group width W of a wide-layout launch on ``N`` lanes: the W
    (among the keys of ``resident`` with at least one resident block) of
    least estimated time ``waves(W) · h^(−log2 W)``: ``waves(W)`` the rounds
    of ``resident[W]`` blocks (blocks per SM · SMs) its ``N·W`` threads
    need, and a lane-step's latency falling by ``h`` (:data:`_WIDE_HALVING`)
    as W doubles; ties to the smaller W.  Raises ValueError when no W
    fits."""
    best = None
    for w in sorted(resident):
        if resident[w] < 1:
            continue
        blocks = -(-N * w // _BLOCK)
        est = -(-blocks // resident[w]) * _WIDE_HALVING ** -math.log2(w)
        if best is None or est < best[0] - 1e-9:
            best = (est, w)
    if best is None:
        raise ValueError(f"no group width fits (resident blocks by W: {resident})")
    return best[1]


def choose_group(N: int, resident, C: int = _MAX_C) -> int:
    """The group size G of a launch on ``N`` lanes: the G (dividing C, among
    the keys of ``resident`` with at least one resident block) of least
    estimated time ``waves(G)·((1 − r)/G + r)``, with ``waves(G)`` the
    rounds of ``resident[G]`` blocks (blocks per SM · SMs) its ``N·G``
    threads need and ``r`` the repeated share of a lane-step; ties to the
    smaller G.  Raises ValueError when no G fits."""
    best = None
    for g in sorted(resident):
        if C % g or resident[g] < 1:
            continue
        blocks = -(-N * g // _BLOCK)
        est = -(-blocks // resident[g]) * ((1 - _REPEATED) / g + _REPEATED)
        if best is None or est < best[0] - 1e-9:
            best = (est, g)
    if best is None:
        raise ValueError(f"no group size fits (resident blocks by G: {resident})")
    return best[1]


def _sec_rows(sec_mask: int) -> int:
    """How many of the 8 secondary rows the terms of ``sec_mask`` read (a
    copy of ``sec_rows_needed`` in ``csrc/megastep.cuh``: alpha reads alpha
    and mid, beta beta and seed, gamma gamma, mid and hspan, delta delta and
    tbar)."""
    rows = set()
    for bit, names in ((1, "alpha mid"), (2, "beta seed"), (4, "gamma mid hspan"),
                       (8, "delta tbar")):
        if sec_mask & bit:
            rows.update(names.split())
    return len(rows)


def megastep_smem_bytes(V: int, nlinks: int, nbranch: int, C: int, G: int,
                        sec_mask: int, ncol: int = 0, K: int = 0, T: int = 0) -> int:
    """Dynamic shared memory of one megastep block, bytes, at group size
    ``G`` (the width W in the wide layout).  ``ncol`` 0: the narrow layout,
    a copy of ``layout()`` in ``csrc/megastep.cuh`` — the link table, the
    branch frames per thread, the lane rows per lane (span, cmin, cmax and,
    with secondary terms, the 8·V secondary rows), with secondary terms each
    thread's children's two fitness values.  ``ncol`` > 0 (the wide
    layout's linearization columns): a copy of ``wide_layout()`` in
    ``csrc/megastep_wide.cuh`` — the block tables (the link table, two ints a
    link, the column table, each goal instance's column count and list, the
    goal instances' kinds and tips, the tips' slots), then one region a lane
    of an odd number of words: 8 rows of V, the secondary rows its terms
    read, the incumbent, the children's block (max(C, 13) rows of V | 1, or
    the link frames where those take more), the linearization, the tips, the goal
    rows, two vectors' tip components, the goal gradient, two vectors' goal
    terms, the children's secondary fitness and eight scalars."""
    if ncol:
        lane = (8 * V + _sec_rows(sec_mask) * V + V + 7 * T
                + max(max(C, 13) * (V | 1), 7 * nlinks) + 7 * ncol + 7 * T + 12 * K
                + 14 * K + 7 * K + 2 * K + (C if sec_mask else 0) + 8) | 1
        block = (nlinks * (_LINK_I + _LINK_F + 2) + V * (T + K) + K + K * V
                 + 2 * K + T)
        return 4 * (block + lane * (_BLOCK // G))
    lanes = _BLOCK // G
    words = (nlinks * (_LINK_I + _LINK_F) + nbranch * 7 * _BLOCK
             + (3 + 8 * bool(sec_mask)) * V * lanes
             + (C // G * 2 * _BLOCK if sec_mask else 0))
    return 4 * words


class MegastepInstance(NamedTuple):
    """The CUDA source that holds a megastep shape: a file of ``csrc/`` or
    a generated name (``kernels/build.generate``), whether it has the wide
    layout, and the group sizes it builds."""
    source: str
    wide: bool
    groups: tuple
    generated: bool


def _generated_text(V: int, K: int, T: int, groups) -> str:
    gx = " ".join(f"X(v, k, t, {g})" for g in groups)
    return (f"// The wide megastep instance (V, K, T) = ({V}, {K}, {T}) at the group\n"
            f"// sizes {', '.join(map(str, groups))}, generated by "
            "bio_ik_tpu_torch/kernels/bio2_megastep.py::\n"
            "// megastep_instance (the step, the kernels and the C API are\n"
            "// csrc/megastep.cuh).\n"
            f"#define SHAPES(X) X({V}, {K}, {T})\n"
            f"#define GROUPS(X, v, k, t) {gx}\n"
            "#define MEGASTEP_WIDE 1\n\n"
            '#include "megastep.cuh"\n')


def megastep_instance(V: int, K: int, T: int, kinds, sec_mask: int, chain,
                      C: int = _MAX_C) -> MegastepInstance:
    """The instance that runs the megastep on (V, K, T) with the goal
    ``kinds`` and the secondary terms of ``sec_mask``: the prebuilt source
    of :data:`MEGASTEP_SOURCES` that has the shape (the narrow ``megastep``
    source for the pose family only), else an instance of the wide layout
    generated for the shape, at the widths of :func:`wide_widths` whose
    block fits.  ``chain`` is ``(nlinks, nbranch, ncol)`` of the problem's link
    table and dependency columns, which size the block: a generated
    instance leaves out the group sizes whose block exceeds the card's
    shared memory (:data:`bio2_step.SMEM_OPTIN`), and a ValueError naming
    the bytes is raised where no group size of the instance fits."""
    from .build import generate

    pose_only = set(kinds) <= set(POSE_KINDS)
    inst = None
    for src, shapes in MEGASTEP_SOURCES.items():
        if (V, K, T) in shapes and (src != "megastep" or pose_only):
            inst = MegastepInstance(src, src != "megastep", MEGASTEP_GROUPS[src], False)
            break
    candidates = inst.groups if inst else wide_widths(V)
    nlinks, nbranch, ncol = chain
    ncol = ncol if (inst is None or inst.wide) else 0
    smem = {g: megastep_smem_bytes(V, nlinks, nbranch, C, g, sec_mask, ncol, K, T)
            for g in candidates if ncol or C % g == 0}
    fits = tuple(g for g, b in smem.items() if b <= SMEM_OPTIN)
    if not fits:
        raise ValueError(
            f"no group size of the megastep instance (V, K, T) = {(V, K, T)} "
            f"fits in the card's {SMEM_OPTIN} bytes of shared memory per block: "
            f"{smem} bytes by group size")
    if inst is None:
        name = f"megastep_gen_{V}_{K}_{T}_g{''.join(map(str, fits))}"
        generate(name, _generated_text(V, K, T, fits), ["--split-compile=0"])
        inst = MegastepInstance(name, True, fits, True)
    return inst


def fullstep_bytes_per_lane(sp: SpeciesParams, F: int) -> int:
    """Bytes per lane of one fullstep launch in noise-tensor mode, each input
    read once and each output written once: the TPU kernel's cost estimate
    (bio2_fullstep.py:705-706) — noise, rates, genes/grads in and out, the
    three bound rows, the fixed rows."""
    return 4 * (sp.gens * sp.V * sp.C + sp.gens * sp.C + 4 * _P * sp.V
                + 3 * sp.V + max(F, 1))


def make_megastep_body(model, tip_links, active_vars, inst_tip,
                       sp: SpeciesParams, n_steps: int, sec_terms=(),
                       inst_kind=None):
    """Build the chunk body over ``(rows, N)`` tensors.

    Returns ``(body, F)``; ``body(state, consts, draw)`` advances

      state  = (genes (2V,N), grads (2V,N), sfit (1,N),
                sol (V,N), sol_fit (1,N), sol_tips (7T,N))
      consts = (qfix (max(F,1),N), gpos (3K,N), gquat (4K,N),
                [gaux (3K,N),] wpos (K,N), wrot (K,N),
                span/cmin/cmax/amin/amax (V,N)[, sec (8V,N)])

    by ``n_steps`` fused steps (``gaux`` iff an instance of ``inst_kind``
    is of :data:`bio2_fullstep.AUX_KINDS`, ``sec`` iff ``sec_terms``);
    ``draw(i) → (draw_gen, wipe_u (1,N), wipe_g (V,N))`` supplies step i's
    randomness.
    """
    inner, F = make_fullstep_inner(model, tip_links, active_vars, inst_tip,
                                   sp, sec_terms=sec_terms, inst_kind=inst_kind)
    V = sp.V
    na = int(any(k in AUX_KINDS for k in (inst_kind or ())))

    def body(state, consts, draw):
        genes, grads, sfit, sol, sol_fit, sol_tips = state
        goal = tuple(consts[:3 + na])                 # qfix, gpos, gquat[, gaux]
        wpos, wrot, span, cmin, cmax, amin, amax = consts[3 + na:10 + na]
        sec_args = tuple(consts[10 + na:])
        N = genes.shape[-1]
        even = (torch.arange(N, device=genes.device) % 2 == 0)[None, :]

        def partner(x):
            """The paired-species lane values (adjacent-lane exchange)."""
            return torch.where(even, torch.roll(x, -1, -1), torch.roll(x, 1, -1))

        for i in range(n_steps):
            draw_gen, wipe_u, wipe_g = draw(i)
            genes, grads, tips, fit = inner(
                genes, grads, *goal, wpos, wrot, span, cmin, cmax, *sec_args,
                draw_gen)

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


def array_draw(noise, rates, wipe_u, wipe_g, gens: int, keep=None):
    """``draw(i)`` over caller-provided noise tensors (noise-tensor mode);
    ``keep (steps·gens, 1, N)`` with secondary goals."""
    def draw(i):
        g0 = i * gens
        k = None if keep is None else keep[g0:g0 + gens]
        return (array_draw_gen(noise[g0:g0 + gens], rates[g0:g0 + gens], k),
                wipe_u[i], wipe_g[i])

    return draw


def philox_draw(seed: int, salt, V: int, C: int, gauss_mode: str = "clt4",
                keep: bool = False, lane=None):
    """``draw(i)`` from the Philox stream the CUDA kernel draws in-kernel
    (``draw_gen(g)`` of one generation, or of a ``(G, 1, 1)`` int64 tensor
    of generations at once, with a leading G axis):
    counter ``(lane, step i, generation g, draw)`` under key ``(seed, 0)``,
    the lane's salt XORed into every word.  Child c's clt4 Gaussians come
    from draws ``c·NC … c·NC + NC − 1`` (``NC = ceil(3V/4)``): their words
    in order are one bit string of 24-bit fields (:func:`packed_fields`),
    Gaussian v the integer sum of fields ``4v … 4v + 3``
    (:func:`clt4_from_fields`).  Box–Muller Gaussian (v, c) is draw
    ``v·C + c``, from its first two words.  The C rates
    are the 4-bit fields of draw ``V·C`` (:func:`rates_from_words`), and
    with ``keep`` (secondary goals) that draw's last word is the
    pre-selection uniform; the wipe coin and restart genes are words 0 and
    ``1 + v`` of draws 0, 1, … (four words each) of generation word
    ``0xFFFFFFFF``.  ``salt`` is the ``(1, N)`` int32 per-lane salt;
    ``lane`` (default ``0 … N−1``) the ``(1, N)`` int64 lane index each
    column had in its launch — several launches' lanes side by side."""
    if gauss_mode not in GAUSS_MODES:
        raise ValueError(f"gauss_mode must be one of {GAUSS_MODES}")
    if C > _MAX_C:
        raise ValueError(f"{C} children exceed the kernel's {_MAX_C}")
    dev = salt.device
    salt64 = salt.to(torch.int64) & 0xFFFFFFFF
    N = salt.shape[-1]
    if lane is None:
        lane = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    NC = clt4_calls(V)
    gidx = torch.arange(C * NC if gauss_mode == "clt4" else V * C, device=dev,
                        dtype=torch.int64)[:, None]
    ridx = torch.full((1, 1), V * C, device=dev, dtype=torch.int64)

    def draw(i):
        def draw_gen(g):
            w = philox_words(seed, lane, i, g, gidx, salt64)
            lead = w[0].shape[:-2]     # (G,) for a (G, 1, 1) tensor of generations
            if gauss_mode == "clt4":       # child c's words: (..., c, 4·NC, N)
                cw = torch.stack(w, -2).reshape(*lead, C, 4 * NC, N).unbind(-2)
                f = packed_fields(cw, 4 * V)
                noise = torch.stack([clt4_from_fields(f[4 * v:4 * v + 4])
                                     for v in range(V)], -3)
            else:
                noise = gauss_from_u01([u01_from_bits(w[0], lo=2.0 ** -25),
                                        u01_from_bits(w[1])], gauss_mode)
            noise = noise.reshape(*lead, V, C, N)
            rw = philox_words(seed, lane, i, g, ridx, salt64)
            rates = rates_from_words(rw, C)
            if keep:
                return noise, rates, u01_from_bits(rw[3])
            return noise, rates

        return (draw_gen,) + philox_wipe(seed, lane, salt64, i, V)

    return draw


def philox_wipe(seed: int, lane, salt64, step: int, V: int):
    """Step ``step``'s wipe coin ``(1, n)`` and restart genes ``(V, n)`` of
    the lanes ``lane (1, n)`` (int64 lane indices, ``salt64`` their salts as
    int64 32-bit values): words 0 and ``1 + v`` of draws 0, 1, … (four
    words each) of generation word ``0xFFFFFFFF``, as :func:`philox_draw`
    and the megastep kernel draw them."""
    widx = torch.arange((V + 4) // 4, device=lane.device, dtype=torch.int64)[:, None]
    ww = torch.stack(philox_words(seed, lane, step, _WIPE_GEN, widx, salt64), 1)
    # word k = call k // 4, word k % 4
    u = u01_from_bits(ww.reshape(-1, lane.shape[-1])[:1 + V])
    return u[0:1], u[1:]


def _branch_slots(link_i):
    """Per link, its slot among the frames the kernel keeps in shared
    memory — the links that a later link hangs from other than the next
    one (which reads the running frame) — or -1."""
    keep = np.zeros(len(link_i), bool)
    for s, (par, _, kind, _, _, pre) in enumerate(link_i):
        if par >= 0 and par != s - 1 and kind != 3 and not pre:   # SRC_CONST
            keep[par] = True
    return np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)


def dependency_columns(link_i, V: int, T: int, inst_tip):
    """The wide kernel's lane linearization by column: ``(cols, ncol)``.
    Column ``tcol[v·T + t]`` holds ∂tip_t/∂x_v in shared memory, −1 where
    tip t does not depend on variable v (the JAX body's ``dts[v][t] is
    None``, skipped at trace time), from the link table's variable slots
    and tip masks; ``cols`` is ``tcol`` followed by ``kcol[k·V + v] =
    tcol[v·T + inst_tip[k]]``, the columns goal instance k reads."""
    dep = np.zeros((V, T), bool)
    for row in link_i:
        for t in range(T):
            if (row[4] >> t) & 1:
                dep[row[3], t] = True
    tcol = np.where(dep, np.cumsum(dep.reshape(-1)).reshape(V, T) - 1, -1)
    kcol = tcol[:, list(inst_tip)].T
    return (np.concatenate([tcol.reshape(-1), kcol.reshape(-1)]).astype(np.int32),
            int(dep.sum()))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(t, shape, name, dev, dtype=torch.float32):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want a contiguous {dtype} {tuple(shape)} tensor on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


class _StepKernel:
    """What :class:`Megastep` and :class:`Fullstep` share: the instance's
    source (:func:`megastep_instance`, resolved on first use: a prebuilt
    file of ``csrc/`` or a generated instance), its chain, goal-kind and
    column tables on each device, and the shape check."""

    def __init__(self, model, tip_links, active_vars, inst_tip,
                 sp: SpeciesParams, gauss_mode: str, sec_terms=(), inst_kind=None):
        if gauss_mode not in GAUSS_MODES:
            raise ValueError(f"gauss_mode must be one of {GAUSS_MODES}")
        self.sp, self.gauss_mode = sp, gauss_mode
        self.sec_terms = tuple(sec_terms)
        self.sec_mask = sec_term_mask(self.sec_terms)
        self.T = len(tip_links)
        self.inst_kind = tuple(inst_kind or ("pose",) * sp.K)
        self.has_aux = any(k in AUX_KINDS for k in self.inst_kind)
        link_i, link_f, tip_slot = FkRows(
            model, tip_links, active_vars).chain_arrays()
        branch = _branch_slots(link_i)
        self.nbranch = int((branch >= 0).sum())
        cols, self._wide_ncol = dependency_columns(link_i, sp.V, self.T, inst_tip)
        self._chain = (np.concatenate([link_i, branch[:, None]], 1), link_f,
                       tip_slot, np.asarray(inst_tip, np.int32),
                       np.asarray([KIND_CODE[k] for k in self.inst_kind], np.int32),
                       cols)
        self._instance = None
        self._chain_dev = {}
        self._groups = {}

    @property
    def instance(self) -> MegastepInstance:
        """The instance's source (:func:`megastep_instance`); a ValueError
        naming the bytes where no group size of it fits on the card."""
        if self._instance is None:
            self._instance = megastep_instance(
                self.sp.V, self.sp.K, self.T, self.inst_kind, self.sec_mask,
                (self._chain[0].shape[0], self.nbranch, self._wide_ncol), self.sp.C)
        return self._instance

    @property
    def source(self) -> str:
        return self.instance.source

    @property
    def groups(self) -> tuple:
        return self.instance.groups

    @property
    def ncol(self) -> int:
        """The linearization's columns in shared memory (0: the narrow
        layout keeps it in registers)."""
        return self._wide_ncol if self.instance.wide else 0

    def _lib(self, N):
        from .build import load

        sp = self.sp
        if N % 2:
            raise ValueError(f"lane count {N} must be even (species pairs)")
        if sp.C > _MAX_C:
            raise ValueError(f"{sp.C} children exceed the kernel's {_MAX_C}")
        return load(self.source)

    def smem_bytes(self, lib, G: int) -> int:
        """Dynamic shared memory of one block of the instance at group G."""
        fn = lib.megastep_smem_bytes
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_uint] + [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return fn(self.sp.V, self._chain[0].shape[0], self.nbranch, self.sp.C,
                  G, self.sec_mask, self.ncol, self.sp.K, self.T)

    def smem_bytes_py(self, G: int) -> int:
        """The same from the Python copy of the layout
        (:func:`megastep_smem_bytes`)."""
        return megastep_smem_bytes(self.sp.V, self._chain[0].shape[0], self.nbranch,
                                   self.sp.C, G, self.sec_mask, self.ncol, self.sp.K,
                                   self.T)

    def resident_blocks(self, lib, dev, G: int) -> int:
        """Blocks of the instance at group G the card holds at once: 0 where
        a block does not fit (its shared memory over the card's opt-in limit,
        or too many registers)."""
        fn = lib.megastep_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        rc = fn(self.sp.V, self.sp.K, self.T, int(bool(self.sec_mask)), G,
                self.smem_bytes(lib, G), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"megastep occupancy query at G={G} failed: "
                               f"CUDA error {rc}")
        return blocks.value * torch.cuda.get_device_properties(dev).multi_processor_count

    def group(self, lib, dev, N: int) -> int:
        """The group size of a launch on N lanes (:func:`choose_group` over
        the group sizes that fit; :func:`choose_width` in the wide
        layout)."""
        if (dev, N) not in self._groups:
            wide = self.instance.wide
            resident = {g: self.resident_blocks(lib, dev, g) for g in self.groups
                        if wide or self.sp.C % g == 0}
            if not any(resident.values()):
                raise RuntimeError(
                    f"no group size of the megastep instance (V, K, T) = "
                    f"{(self.sp.V, self.sp.K, self.T)} with secondary terms "
                    f"{self.sec_terms} fits on the card: shared memory per block "
                    f"{ {g: self.smem_bytes(lib, g) for g in resident} } bytes")
            self._groups[dev, N] = (choose_width(N, resident) if wide
                                    else choose_group(N, resident, self.sp.C))
        return self._groups[dev, N]

    def _chain_on(self, dev):
        if dev not in self._chain_dev:
            self._chain_dev[dev] = tuple(torch.as_tensor(a, device=dev)
                                         for a in self._chain)
        return self._chain_dev[dev]


class Megastep(_StepKernel):
    """The megastep for one (model, tips, active set, goal instances,
    species params, n_steps, secondary terms); call it on the solver state.

    ``Megastep.launches`` counts kernel launches over all instances; it is
    incremented only where the CUDA kernel is launched.
    """

    launches = 0

    def __init__(self, model, tip_links, active_vars, inst_tip,
                 sp: SpeciesParams, n_steps: int, gauss_mode: str = "clt4",
                 sec_terms=(), inst_kind=None):
        super().__init__(model, tip_links, active_vars, inst_tip, sp,
                         gauss_mode, sec_terms, inst_kind)
        self.n_steps = n_steps
        self.body, self.F = make_megastep_body(
            model, tip_links, active_vars, inst_tip, sp, n_steps,
            sec_terms=self.sec_terms, inst_kind=self.inst_kind)
        self.state_rows = [_P * sp.V, _P * sp.V, 1, sp.V, 1, 7 * self.T]
        self.const_names = ["qfix", "gpos", "gquat"] + ["gaux"] * self.has_aux + [
            "wpos", "wrot", "span", "cmin", "cmax", "amin", "amax"] + [
            "sec"] * bool(self.sec_terms)
        rows = dict(qfix=max(self.F, 1), gpos=3 * sp.K, gquat=4 * sp.K,
                    gaux=3 * sp.K, wpos=sp.K, wrot=sp.K, sec=8 * sp.V)
        self.const_rows = [rows.get(n, sp.V) for n in self.const_names]

    def __call__(self, state, consts, *, seed=None, salt=None, noise=None,
                 rates=None, wipe_u=None, wipe_g=None, keep=None, group=None):
        """Advance ``state`` by ``n_steps`` steps.  Either ``seed`` (int) and
        ``salt`` ((1, N) int32) for in-kernel Philox, or the noise tensors
        (``keep`` too with secondary terms).  ``group`` fixes the kernel's
        group size G (default: :meth:`group`'s choice).  Returns the new
        state tuple."""
        tensors = noise is not None
        if len(consts) != len(self.const_names):
            raise ValueError(f"want the consts {self.const_names}, got {len(consts)}")
        if not tensors and (seed is None or salt is None):
            raise ValueError("pass seed and salt, or the noise tensors")
        if tensors and bool(self.sec_terms) != (keep is not None):
            raise ValueError("pass keep exactly when the step has secondary terms")
        dev = state[0].device
        if dev.type == "cpu":
            sp = self.sp
            if tensors:
                draw = array_draw(noise, rates, wipe_u, wipe_g, sp.gens, keep)
            else:
                draw = philox_draw(int(seed), salt, sp.V, sp.C, self.gauss_mode,
                                   keep=bool(self.sec_terms))
            return self.body(tuple(state), tuple(consts), draw)
        if dev.type == "cuda":
            return self._launch(state, consts, seed, salt,
                                (noise, rates, wipe_u, wipe_g, keep)
                                if tensors else None, group)
        raise ValueError(f"megastep runs on cuda or cpu tensors, not {dev}")

    # ------------------------------------------------------------------
    def _launch(self, state, consts, seed, salt, rng, group):
        sp = self.sp
        genes = state[0]
        dev = genes.device
        N = genes.shape[-1]
        lib = self._lib(N)
        G = self.group(lib, dev, N) if group is None else group
        if G not in self.groups or (not self.instance.wide and sp.C % G):
            raise ValueError(f"group size {G} must be one of {self.groups}"
                             + ("" if self.instance.wide else f" and divide C = {sp.C}"))
        for t, r, nm in zip(state, self.state_rows,
                            ("genes", "grads", "sfit", "sol", "sol_fit",
                             "sol_tips")):
            _check(t, (r, N), nm, dev)
        for t, r, nm in zip(consts, self.const_rows, self.const_names):
            _check(t, (r, N), nm, dev)
        named = dict(zip(self.const_names, consts))
        # the kernel's order: the pose-family rows, then sec and gaux
        rows = [named[n] for n in ("qfix", "gpos", "gquat", "wpos", "wrot", "span",
                                   "cmin", "cmax", "amin", "amax")]
        sec = named.get("sec", genes)                            # unread without
        gaux = named.get("gaux", named["gpos"])                  # (3K, N) either way
        steps_gens = self.n_steps * sp.gens
        if rng is None:
            _check(salt, (1, N), "salt", dev, torch.int32)
            rng_mode = _RNG_CODE[self.gauss_mode]
            noise = rates = wipe_u = wipe_g = keep = genes        # unread
        else:
            noise, rates, wipe_u, wipe_g, keep = rng
            _check(noise, (steps_gens, sp.V, sp.C, N), "noise", dev)
            _check(rates, (steps_gens, sp.C, N), "rates", dev)
            _check(wipe_u, (self.n_steps, 1, N), "wipe_u", dev)
            _check(wipe_g, (self.n_steps, sp.V, N), "wipe_g", dev)
            if self.sec_terms:
                _check(keep, (steps_gens, 1, N), "keep", dev)
            else:
                keep = genes                                      # unread
            salt = torch.zeros((1, N), dtype=torch.int32, device=dev)
            seed = 0
            rng_mode = 0
        chain_i, chain_f, tip_slot, inst_tip, kinds, cols = self._chain_on(dev)
        out = tuple(torch.empty_like(t) for t in state)
        fn = lib.megastep_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_uint, ctypes.c_uint]
                       + [ctypes.c_void_p] * 36 + [ctypes.c_int, ctypes.c_void_p])
        rc = fn(sp.V, sp.K, self.T, G, N, chain_i.shape[0], self.nbranch,
                self.n_steps, sp.gens, sp.C, sp.mem_iters, _MEMETIC_CODE[sp.memetic],
                sp.h, rng_mode, int(seed) & 0xFFFFFFFF, self.sec_mask,
                _ptr(salt), *(_ptr(t) for t in state), *(_ptr(t) for t in out),
                *(_ptr(t) for t in rows), _ptr(sec),
                _ptr(noise), _ptr(rates), _ptr(wipe_u), _ptr(wipe_g), _ptr(keep),
                _ptr(chain_i), _ptr(chain_f), _ptr(tip_slot), _ptr(inst_tip),
                _ptr(gaux), _ptr(kinds), _ptr(cols), self.ncol,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"megastep launch failed: CUDA error {rc}")
        Megastep.launches += 1
        return out


class Fullstep(_StepKernel):
    """One bio2 step with no species bookkeeping — the port of the TPU
    kernel ``make_fullstep_kernel`` (no secondary goals, as there).  Call it
    on ``genes, grads (2V,N), qfix (max(F,1),N), gpos (3K,N), gquat (4K,N),
    [gaux (3K,N),] wpos, wrot (K,N), span, cmin, cmax (V,N)`` (``gaux`` as
    for :class:`Megastep`) with either ``noise (gens,V,C,N)`` and ``rates
    (gens,C,N)`` or ``seed`` and ``salt`` (Philox, step word 0, clt4
    gaussians); returns ``genes', grads', tips (7T,N), fit (1,N)``.  On CPU
    tensors it runs the plain :func:`make_fullstep_inner`, on CUDA tensors
    the ``fullstep_launch`` entry of the instance's source.

    ``Fullstep.launches`` counts kernel launches; it is incremented only
    where the CUDA kernel is launched.
    """

    launches = 0

    def __init__(self, model, tip_links, active_vars, inst_tip,
                 sp: SpeciesParams, inst_kind=None):
        super().__init__(model, tip_links, active_vars, inst_tip, sp, "clt4",
                         inst_kind=inst_kind)
        self.inner, self.F = make_fullstep_inner(
            model, tip_links, active_vars, inst_tip, sp, inst_kind=self.inst_kind)
        self.rows = ((("genes", _P * sp.V), ("grads", _P * sp.V),
                      ("qfix", max(self.F, 1)), ("gpos", 3 * sp.K),
                      ("gquat", 4 * sp.K))
                     + (("gaux", 3 * sp.K),) * self.has_aux
                     + (("wpos", sp.K), ("wrot", sp.K),
                        ("span", sp.V), ("cmin", sp.V), ("cmax", sp.V)))

    def __call__(self, *args, noise=None, rates=None, seed=None, salt=None):
        if len(args) != len(self.rows):
            raise ValueError(f"want the {len(self.rows)} tensors "
                             f"{[n for n, _ in self.rows]}, got {len(args)}")
        genes = args[0]
        tensors = noise is not None
        if not tensors and (seed is None or salt is None):
            raise ValueError("pass seed and salt, or noise and rates")
        dev = genes.device
        if dev.type == "cpu":
            if tensors:
                draw_gen = array_draw_gen(noise, rates)
            else:
                draw_gen = philox_draw(int(seed), salt, self.sp.V, self.sp.C,
                                       self.gauss_mode)(0)[0]
            return self.inner(*args, draw_gen)
        if dev.type == "cuda":
            return self._launch(args, noise, rates, seed, salt)
        raise ValueError(f"fullstep runs on cuda or cpu tensors, not {dev}")

    def _launch(self, args, noise, rates, seed, salt):
        sp = self.sp
        genes = args[0]
        dev = genes.device
        N = genes.shape[-1]
        lib = self._lib(N)
        for t, (nm, r) in zip(args, self.rows):
            _check(t, (r, N), nm, dev)
        named = {nm: t for t, (nm, _) in zip(args, self.rows)}
        gaux = named.get("gaux", named["gpos"])                  # (3K, N) either way
        args = [named[n] for n in ("genes", "grads", "qfix", "gpos", "gquat", "wpos",
                                   "wrot", "span", "cmin", "cmax")]
        if noise is None:
            _check(salt, (1, N), "salt", dev, torch.int32)
            rng_mode = _RNG_CODE[self.gauss_mode]
            noise = rates = genes                                 # unread
        else:
            _check(noise, (sp.gens, sp.V, sp.C, N), "noise", dev)
            _check(rates, (sp.gens, sp.C, N), "rates", dev)
            salt = torch.zeros((1, N), dtype=torch.int32, device=dev)
            seed = 0
            rng_mode = 0
        chain_i, chain_f, tip_slot, inst_tip, kinds, cols = self._chain_on(dev)
        genes_o, grads_o = torch.empty_like(genes), torch.empty_like(genes)
        tips_o = torch.empty((7 * self.T, N), dtype=torch.float32, device=dev)
        fit_o = torch.empty((1, N), dtype=torch.float32, device=dev)
        fn = lib.fullstep_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_uint]
                       + [ctypes.c_void_p] * 24 + [ctypes.c_int, ctypes.c_void_p])
        rc = fn(sp.V, sp.K, self.T, N, chain_i.shape[0], self.nbranch, sp.gens, sp.C,
                sp.mem_iters, _MEMETIC_CODE[sp.memetic], sp.h, rng_mode,
                int(seed) & 0xFFFFFFFF, _ptr(salt),
                *(_ptr(t) for t in args), _ptr(noise), _ptr(rates),
                _ptr(genes_o), _ptr(grads_o), _ptr(tips_o), _ptr(fit_o),
                _ptr(chain_i), _ptr(chain_f), _ptr(tip_slot), _ptr(inst_tip),
                _ptr(gaux), _ptr(kinds), _ptr(cols), self.ncol,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"fullstep launch failed: CUDA error {rc}")
        Fullstep.launches += 1
        return genes_o, grads_o, tips_o, fit_o
