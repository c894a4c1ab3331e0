"""The bio2 species step on a given linearization, and its kernel wrapper.

Port of :mod:`bio_ik_tpu.kernels.bio2_step`.  One call runs the whole bio2
species inner loop for a batch of lanes — ``gens`` generations of mutate →
quaternion renormalization → linearized fitness → select-2, then
``mem_iters`` memetic line-search iterations on parent 0 (reference:
ik_evolution_2.cpp:242-600, forward_kinematics.h:932-1233).  The caller
linearizes at parent 0 between calls; this is the engine's species tier,
used for chains with floating or planar joints.

:func:`make_species_inner` is the plain torch version over ``(rows, N)``
tensors; :class:`SpeciesKernel` is the wrapper a caller uses: on CUDA
tensors it launches the hand-written kernel of ``csrc/species.cu``, on CPU
tensors it runs the plain version.  There is no fallback between the two.

Two randomness modes, as the megastep's: noise tensors from the caller (the
TPU kernel's interface, in which the plain version is held to the JAX
package's), or in-kernel Philox from ``(seed, step, salt)`` — the
megastep's stream and mapping, whose plain version is
``bio2_megastep.philox_draw``.

With joint-space secondary goals (``sec_terms``, the packed :data:`SEC_ROWS`
const from ``engine._secondary_rows``) each generation ranks the children by
secondary fitness and keeps a random-count best prefix for the primary
selection, and the memetic line search runs on the combined fitness while
accepting on the primary (reference: ik_evolution_2.cpp:366-378, :459-537).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["SpeciesParams", "SEC_ROWS", "SEC_TERMS", "_P", "make_sec_eval",
           "preselect", "sec_term_mask", "quat_mask", "make_species_inner", "SpeciesKernel",
           "SPECIES_SHAPES", "species_flops_per_lane", "species_bytes_per_lane",
           "species_philox_calls_per_lane"]

_P = 2  # parents kept per species (reference: population_size=2, ik_evolution_2.cpp:137)

# packed per-variable secondary-fitness rows inside the ``sec (8·V, N)``
# const (engine._secondary_rows builds them in this order) — the
# coefficient/center rows of the joint-space quadratic
#   sec(x) = Σ_v α(x−mid)² + β(x−seed)² + γ·relu(2|x−mid|−hspan)² + δ(x−tbar)²
# covering center_joints (α), regularization/minimal_displacement (β),
# avoid_joint_limits (γ) and joint_variable (δ) (reference:
# computeSecondaryFitnessActiveVariables, ik_base.h:163-185).  Constant
# offsets are dropped: every kernel use (pre-selection ranks, line-search
# differences, gradients) is invariant to them.
SEC_ROWS = ("alpha", "beta", "gamma", "delta", "tbar", "mid", "hspan",
            "seed")
SEC_TERMS = ("alpha", "beta", "gamma", "delta")

# (V, K, quaternion mask) instances of csrc/species.cu (its SHAPES macro):
# free_arm (a floating joint's quaternion genes at slot 3: mask 8) and
# planar_arm (none)
SPECIES_SHAPES = ((10, 1, 8), (5, 1, 0))

_MEMETIC_CODE = {"": 0, "q": 1, "l": 2}
_RNG_CODE = {"clt4": 1, "box_muller": 2}   # csrc/species.cu rng_mode (0: tensors)
_MAX_C = 16           # children per generation the kernel takes (MAX_C)


def quat_mask(quat_slices) -> int:
    """Bit ``s`` set for each quaternion gene block starting at slot ``s``
    (the species kernel's instance parameter)."""
    return sum(1 << s for s in quat_slices)


def sec_term_mask(sec_terms) -> int:
    """Bit ``i`` set for ``SEC_TERMS[i]`` in ``sec_terms`` (the CUDA
    kernels' term mask, csrc/sec_eval.cuh)."""
    bad = set(sec_terms) - set(SEC_TERMS)
    if bad:
        raise ValueError(f"unknown secondary terms {sorted(bad)}")
    return sum(1 << i for i, t in enumerate(SEC_TERMS) if t in sec_terms)


def make_sec_eval(sec, V: int, sec_terms):
    """Secondary fitness and gradient over the packed ``sec (8·V, N)`` rows
    (JAX bio2_step.py:56-103, the same operations in the same order).
    ``sec_terms`` ⊆ :data:`SEC_TERMS` gates the terms the problem has.
    Returns ``(sec_of(xs), sec_grad(xs, v))`` for ``xs`` indexable by
    variable (a list of rows or a ``(V, ...)`` tensor); each row broadcasts
    against ``sec``'s ``(1, N)`` rows."""
    ridx = {name: i for i, name in enumerate(SEC_ROWS)}

    def row(name, v):
        i = ridx[name] * V + v
        return sec[i:i + 1]

    def terms_v(xs, v):
        out = []
        xm = xs[v] - row("mid", v)
        if "alpha" in sec_terms:
            out.append(("alpha", xm))
        if "beta" in sec_terms:
            out.append(("beta", xs[v] - row("seed", v)))
        if "delta" in sec_terms:
            out.append(("delta", xs[v] - row("tbar", v)))
        return out, xm

    def sec_of(xs):
        acc = 0.0
        for v in range(V):
            quads, xm = terms_v(xs, v)
            for name, e in quads:
                acc = acc + row(name, v) * (e * e)
            if "gamma" in sec_terms:
                r = torch.clamp(2.0 * torch.abs(xm) - row("hspan", v), min=0.0)
                acc = acc + row("gamma", v) * (r * r)
        return acc

    def sec_grad(xs, v):
        quads, xm = terms_v(xs, v)
        g = 0.0
        for name, e in quads:
            g = g + 2.0 * row(name, v) * e
        if "gamma" in sec_terms:
            r = torch.clamp(2.0 * torch.abs(xm) - row("hspan", v), min=0.0)
            sgn = torch.where(xm >= 0, 1.0, -1.0).to(xm.dtype)
            g = g + 4.0 * row("gamma", v) * r * sgn
        return g

    return sec_of, sec_grad


def preselect(fit, ssec, keep_u, C: int):
    """The secondary pre-selection of one generation (reference
    :366-378): rank the C children by secondary fitness ``ssec (C, N)``
    (ties to the lower index), keep the best ``int(keep_u·(C−1)) + 1``
    and set the primary fitness of the rest to +inf.  ``fit (2+C, N)`` has
    the two parents first; they always survive."""
    s_i, s_j = ssec[:, None], ssec[None, :]
    idx = torch.arange(C, device=ssec.device)
    ii, jj = idx[:, None, None], idx[None, :, None]
    beats = (s_j < s_i) | ((s_j == s_i) & (jj < ii))
    rank = beats.sum(dim=1)                                  # (C, N)
    kcount = (keep_u * (C - 1)).to(torch.int32) + 1           # ∈ [1, C−1]
    child_keep = rank < kcount
    return torch.cat([fit[:_P], torch.where(child_keep, fit[_P:],
                                            float("inf"))], 0)


class SpeciesParams(NamedTuple):
    """Static shape/config of the fused kernels."""

    V: int            # active variables
    K: int            # pose-goal instances
    C: int = 16       # children per generation (reference :138)
    gens: int = 8     # generations (reference :349-351, memetic variant)
    mem_iters: int = 8  # memetic iterations (reference :453)
    memetic: str = "q"  # 'q' quadratic | 'l' linear | '' none
    h: float = 1e-3   # memetic probe length
    quat_slices: tuple = ()  # start rows of floating-joint quat gene
    #                          blocks, renormalized after each mutation
    #                          (reference: ik_evolution_2.cpp:320-324)


def species_flops_per_lane(sp: SpeciesParams) -> int:
    """FLOPs per lane per launch, as the TPU kernel's cost estimate counts
    them (bio2_step.py:450-452): ``evals·(14KV + 30K)`` with ``evals =
    gens·(C+2) + 4·mem_iters``."""
    evals = sp.gens * (sp.C + _P) + (sp.mem_iters * 4 if sp.memetic else 0)
    return evals * (sp.K * 7 * sp.V * 2 + sp.K * 30)


def species_bytes_per_lane(sp: SpeciesParams, sec_terms=(),
                           rng: str = "tensors") -> int:
    """Bytes per lane per launch, each input read once and each output
    written once: the TPU cost estimate's rows (bio2_step.py:472-473) plus
    the goal rows it leaves out (tips0, gpos, gquat, wpos, wrot: 16·K) and,
    with ``sec_terms``, the packed secondary rows.  ``rng="tensors"``
    counts the noise, rates (and keeps), ``rng="philox"`` the salt in their
    place."""
    V, K = sp.V, sp.K
    sec = len(SEC_ROWS) * V if sec_terms else 0
    if rng == "tensors":
        draws = sp.gens * V * sp.C + sp.gens * sp.C + (sp.gens if sec_terms else 0)
    elif rng == "philox":
        draws = 1
    else:
        raise ValueError(f"rng must be 'tensors' or 'philox', not {rng!r}")
    return 4 * (draws + 4 * _P * V + V * K * 7 + 3 * V + 16 * K + sec)


def species_philox_calls_per_lane(sp: SpeciesParams, gauss_mode: str = "clt4") -> int:
    """Philox4x32-10 calls of one lane's draws in Philox mode: per generation
    ``ceil(3V/4)`` per child (clt4; V for Box–Muller) and one for the rates
    and keep — 1 032 at V = 10, C = 16, gens = 8 under clt4."""
    per_child = (3 * sp.V + 3) // 4 if gauss_mode == "clt4" else sp.V
    return sp.gens * (sp.C * per_child + 1)


def make_species_inner(sp: SpeciesParams, sec_terms=()):
    """Build ``inner(...) -> (genes_out, grads_out)`` on ``(rows, N)``
    tensors.  Row layouts:

      genes/grads   (P·V, N)   parent-major: row p·V+v
      tips0         (K·7, N)   goal-instance tip frames at x0 (pos+quat)
      deltas        (V·K·7, N) row v·K·7 + k·7 + d  (∂tip_kd/∂x_v)
      gpos          (K·3, N), gquat (K·4, N)
      wpos, wrot    (K, N)   position / rotation error weights
      span, cmin, cmax (V, N)
      noise         (gens, V, C, N) unit gaussians
      rates         (gens, C, N) mutation rates (2^(k-23), reference :265)

    With ``sec_terms`` two trailing arguments are required: ``keeps (gens,
    1, N)`` uniforms for the pre-selection prefix and ``sec (8·V, N)``, the
    packed :data:`SEC_ROWS`.

    The linearization point x0 is parent 0 at entry (the caller linearized
    there, reference :341-346).  Work is batched over variables, children
    and tip components, but every element goes through the JAX body's
    operations in its order (sums over v, d and k are sequential), so the
    result is the row-by-row body's, bit for bit.
    """
    V, K, C = sp.V, sp.K, sp.C

    def phen(tips0, D, dq):
        """Approximate tip components ``(7K, M, N)`` for gene offsets ``dq
        (V, M, N)``: ``tips0 + Σ_v deltas_v·dq_v`` in v order (reference:
        computeApproximateMutations, forward_kinematics.h:1061)."""
        acc = tips0
        for v in range(V):
            acc = acc + D[v] * dq[v]
        return acc

    def fitness(ph, gpos, gquat, wpos, wrot):
        """Σ_k wpos·‖Δp‖² + wrot·min(‖q−ĝ‖², ‖q+ĝ‖²) → ``(M, N)``
        (reference: goal_types.h:80-181)."""
        fit = None
        for k in range(K):
            perr = 0.0
            for d in range(3):
                e = ph[k * 7 + d] - gpos[k * 3 + d]
                perr = perr + e * e
            dm = 0.0
            dp = 0.0
            for d in range(4):
                q = ph[k * 7 + 3 + d]
                g = gquat[k * 4 + d]
                dm = dm + (q - g) * (q - g)
                dp = dp + (q + g) * (q + g)
            term = wpos[k] * perr + wrot[k] * torch.minimum(dm, dp)
            fit = term if fit is None else fit + term
        return fit

    def inner(genes, grads, tips0, deltas, gpos, gquat, wpos, wrot,
              span, cmin, cmax, noise, rates, keeps=None, sec=None):
        if sec_terms:
            sec_of, sec_grad = make_sec_eval(sec, V, sec_terms)
        dt = genes.dtype
        dev = genes.device
        N = genes.shape[-1]
        # (rows, 1, N): a row broadcasts over the children axis
        p0g, p1g = genes[:V, None], genes[V:, None]
        p0r, p1r = grads[:V, None], grads[V:, None]
        x0 = p0g  # linearization point (parent 0 at entry)
        spn, clo, chi = span[:, None], cmin[:, None], cmax[:, None]
        tips0 = tips0[:, None]
        D = deltas.reshape(V, K * 7, 1, N)
        gpos, gquat = gpos[:, None], gquat[:, None]
        wpos, wrot = wpos[:, None], wrot[:, None]

        # per-child constants (reference child_index = 2.., :263-269)
        child_global = torch.arange(C, device=dev)[None, :, None] + _P
        fmix = torch.where(child_global % 2 == 0, 0.2, 0.0).to(dt)
        gfac = (child_global % 3).to(dt)

        def pick(pool, idx):
            return torch.gather(pool, 1, idx.expand(V, 1, N))

        # ---- generations (reference :349-431) ---------------------------
        for g in range(sp.gens):
            pgrad = p0r * (1.0 - fmix) + p1r * fmix                  # (V, C, N)
            cg = p0g + noise[g] * (rates[g][None] * spn) + pgrad * gfac
            cg = torch.clamp(cg, clo, chi)
            cr = pgrad * 0.7 + (cg - p0g) * 0.3                      # mix (:299)
            # renormalize floating-joint quaternion blocks of the children
            # (reference :320-324 normalizeFast — one Newton step toward
            # unit norm, frame.h:231-238); the momentum above uses the genes
            # before this step
            for s in sp.quat_slices:
                b = cg[s:s + 4]
                n2 = b[0] * b[0] + b[1] * b[1] + b[2] * b[2] + b[3] * b[3]
                cg[s:s + 4] = b * ((3.0 - n2) * 0.5)
            # pool: parents first (kept alive, reference :381-388)
            pool_g = torch.cat([p0g, p1g, cg], 1)                     # (V, C+2, N)
            pool_r = torch.cat([p0r, p1r, cr], 1)
            fit = fitness(phen(tips0, D, pool_g - x0), gpos, gquat, wpos, wrot)
            if sec_terms:
                fit = preselect(fit, sec_of(cg), keeps[g], C)
            # first-min select of 2 (the JAX body's one-hot pick); kept rows
            # are gathered, so 0·inf never turns into NaN
            i1 = torch.argmin(fit, dim=0, keepdim=True)
            i2 = torch.argmin(fit.scatter(0, i1, float("inf")), dim=0,
                              keepdim=True)
            p0g, p1g = pick(pool_g, i1), pick(pool_g, i2)
            p0r, p1r = pick(pool_r, i1), pick(pool_r, i2)

        # ---- memetic phase on parent 0 (reference :436-600) -------------
        if sp.memetic:
            def f_of(xs):
                ph = phen(tips0, D, xs - x0)
                return fitness(ph, gpos, gquat, wpos, wrot), ph

            x = p0g
            done = torch.zeros((1, N), dtype=torch.bool, device=dev)
            for _ in range(sp.mem_iters):
                f2p, ph = f_of(x)
                # the line search runs on the combined fitness, acceptance
                # stays primary against primary (reference :459-537)
                f2 = f2p + sec_of(x) if sec_terms else f2p
                # analytic gradient of the linearized pose fitness, all v
                # at once
                grad = 0.0
                for k in range(K):
                    dm = 0.0
                    dp = 0.0
                    for d in range(4):
                        q = ph[k * 7 + 3 + d]
                        gq = gquat[k * 4 + d]
                        dm = dm + (q - gq) * (q - gq)
                        dp = dp + (q + gq) * (q + gq)
                    sgn = torch.where(dm <= dp, 1.0, -1.0).to(dt)
                    acc_p = 0.0
                    for d in range(3):
                        e = ph[k * 7 + d] - gpos[k * 3 + d]
                        acc_p = acc_p + D[:, k * 7 + d] * e
                    acc_q = 0.0
                    for d in range(4):
                        e = ph[k * 7 + 3 + d] - sgn * gquat[k * 4 + d]
                        acc_q = acc_q + D[:, k * 7 + 3 + d] * e
                    grad = grad + 2.0 * (wpos[k] * acc_p + wrot[k] * acc_q)
                if sec_terms:
                    grad = grad + torch.stack([sec_grad(x, v) for v in range(V)])
                l1 = 0.0
                for v in range(V):
                    l1 = l1 + torch.abs(grad[v])
                # a true division (``float / tensor`` would multiply by a
                # reciprocal and round differently from the JAX body)
                scale = torch.full_like(l1, sp.h) / (l1 + 1e-12)
                gdir = grad * scale
                xm, xp = x - gdir, x + gdir
                f1, _ = f_of(xm)
                f3, _ = f_of(xp)
                if sec_terms:
                    f1 = f1 + sec_of(xm)
                    f3 = f3 + sec_of(xp)
                if sp.memetic == "q":
                    # quadratic fit (reference :498-516)
                    v1, v2 = f2 - f1, f3 - f2
                    vv = (v1 + v2) * 0.5
                    a = v1 - v2
                    step = vv / a
                    step = torch.where(torch.isfinite(step), step, 0.0)
                    cand = torch.clamp(x + gdir * step, clo, chi)
                else:
                    # linear step (reference :545-556)
                    cost_diff = (f3 - f1) * 0.5
                    step = f2 / cost_diff
                    step = torch.where(torch.isfinite(step), step, 0.0)
                    cand = torch.clamp(x - gdir * step, clo, chi)
                f4p, _ = f_of(cand)
                accept = (f4p < f2p) & ~done
                x = torch.where(accept, cand, x)
                done = done | ~accept  # break on non-improvement (:535-537)
            p0g = x

        return (torch.cat([p0g, p1g]).reshape(_P * V, N),
                torch.cat([p0r, p1r]).reshape(_P * V, N))

    return inner


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


class SpeciesKernel:
    """The species step for one :class:`SpeciesParams` and set of secondary
    terms; call it on the ``(rows, N)`` tensors of :func:`make_species_inner`
    (``keeps`` and ``sec`` last iff ``sec_terms``), or, in Philox mode, on
    the tensors up to ``cmax`` (and ``sec=``) with ``seed``, ``step`` and
    ``salt`` in place of ``noise``, ``rates`` and ``keeps``.

    ``SpeciesKernel.launches`` counts CUDA kernel launches over all
    instances; it is incremented only where the CUDA kernel is launched.
    """

    launches = 0

    def __init__(self, sp: SpeciesParams, sec_terms=()):
        if any(s + 4 > sp.V for s in sp.quat_slices):
            raise ValueError(f"quat_slices {sp.quat_slices} exceed V={sp.V}")
        self.sp = sp
        self.sec_terms = tuple(sec_terms)
        self.sec_mask = sec_term_mask(self.sec_terms)
        self.inner = make_species_inner(sp, self.sec_terms)
        V, K = sp.V, sp.K
        self.rows = (("genes", _P * V), ("grads", _P * V), ("tips0", 7 * K),
                     ("deltas", 7 * V * K), ("gpos", 3 * K), ("gquat", 4 * K),
                     ("wpos", K), ("wrot", K), ("span", V), ("cmin", V),
                     ("cmax", V))

    def __call__(self, genes, grads, tips0, deltas, gpos, gquat, wpos, wrot,
                 span, cmin, cmax, noise=None, rates=None, keeps=None, sec=None,
                 *, seed=None, step: int = 0, salt=None, gauss_mode: str = "clt4"):
        """One species step; returns ``(genes', grads')``.  Either ``noise``
        and ``rates`` (and ``keeps`` with secondary terms), or ``seed``
        (int), ``step`` (int) and ``salt`` ((1, N) int32) for the in-kernel
        Philox draws of ``gauss_mode``."""
        tensors = noise is not None
        if tensors == (seed is not None) or (rates is not None) != tensors \
                or (salt is not None) == tensors:
            raise ValueError("pass noise and rates, or seed and salt (in-kernel "
                             "Philox)")
        if bool(self.sec_terms) != (sec is not None) \
                or (keeps is not None) != (tensors and bool(self.sec_terms)):
            raise ValueError("pass keeps and sec exactly when the step has "
                             "secondary terms (keeps only with noise tensors)")
        if gauss_mode not in _RNG_CODE:
            raise ValueError(f"gauss_mode must be one of {tuple(_RNG_CODE)}")
        args = (genes, grads, tips0, deltas, gpos, gquat, wpos, wrot, span,
                cmin, cmax)
        dev = genes.device
        if dev.type == "cpu":
            if not tensors:
                noise, rates, keeps = self.philox_tensors(seed, step, salt,
                                                          gauss_mode)
            return self.inner(*args, noise, rates,
                              *((keeps, sec) if self.sec_terms else ()))
        if dev.type == "cuda":
            return self._launch(args, noise, rates, keeps, sec, seed, step, salt,
                                gauss_mode)
        raise ValueError(f"the species step runs on cuda or cpu tensors, not {dev}")

    def philox_tensors(self, seed: int, step: int, salt, gauss_mode: str = "clt4"):
        """``(noise (gens, V, C, N), rates (gens, C, N), keeps (gens, 1, N) or
        None)``: the draws the kernel makes in Philox mode, those of
        :func:`bio2_megastep.philox_draw` for each generation (drawn for all
        generations at once)."""
        from .bio2_megastep import philox_draw

        sp = self.sp
        draw_gen = philox_draw(int(seed), salt, sp.V, sp.C, gauss_mode,
                               keep=bool(self.sec_terms))(step)[0]
        gens = torch.arange(sp.gens, dtype=torch.int64, device=salt.device)[:, None, None]
        out = draw_gen(gens)
        return out[0], out[1], out[2] if self.sec_terms else None

    # ------------------------------------------------------------------
    def _launch(self, args, noise, rates, keeps, sec, seed, step, salt, gauss_mode):
        from .build import load

        sp = self.sp
        genes = args[0]
        dev = genes.device
        N = genes.shape[-1]

        def check(t, shape, name, dtype=torch.float32):
            if t.device != dev or t.dtype != dtype \
                    or not t.is_contiguous() or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name}: want a contiguous {dtype} {shape} tensor on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")

        for t, (name, r) in zip(args, self.rows):
            check(t, (r, N), name)
        if sp.C > _MAX_C:
            raise ValueError(f"{sp.C} children exceed the kernel's {_MAX_C}")
        if noise is not None:
            check(noise, (sp.gens, sp.V, sp.C, N), "noise")
            check(rates, (sp.gens, sp.C, N), "rates")
            if self.sec_terms:
                check(keeps, (sp.gens, 1, N), "keeps")
            rng_mode, seed, salt = 0, 0, genes                   # salt unread
        else:
            check(salt, (1, N), "salt", torch.int32)
            rng_mode = _RNG_CODE[gauss_mode]
            noise = rates = genes                                # unread
        if self.sec_terms:
            check(sec, (8 * sp.V, N), "sec")
        keeps = genes if keeps is None else keeps                # unread
        sec = genes if sec is None else sec                      # unread

        lib = load("species")
        lib.species_has_shape.argtypes = [ctypes.c_int] * 2 + [ctypes.c_uint]
        lib.species_has_shape.restype = ctypes.c_int
        qmask = quat_mask(sp.quat_slices)
        if not lib.species_has_shape(sp.V, sp.K, qmask):
            raise ValueError(
                f"the species kernel is not instantiated for V={sp.V}, "
                f"K={sp.K}, quaternion mask {qmask} (SHAPES in csrc/species.cu; "
                "ROADMAP.md, port queue item 9)")
        genes_o, grads_o = torch.empty_like(genes), torch.empty_like(genes)
        fn = lib.species_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_uint,
                                            ctypes.c_uint, ctypes.c_int,
                                            ctypes.c_uint, ctypes.c_int]
                       + [ctypes.c_void_p] * 19)
        rc = fn(sp.V, sp.K, N, sp.gens, sp.C, sp.mem_iters,
                _MEMETIC_CODE[sp.memetic], sp.h, qmask, self.sec_mask, rng_mode,
                int(seed) & 0xFFFFFFFF, int(step), _ptr(salt),
                *(_ptr(t) for t in args), _ptr(noise), _ptr(rates), _ptr(keeps),
                _ptr(sec), _ptr(genes_o), _ptr(grads_o),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"species launch failed: CUDA error {rc}")
        SpeciesKernel.launches += 1
        return genes_o, grads_o
