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

The secondary-goal pre-selection of the JAX body (``sec_terms``) is not
ported yet (ROADMAP.md, port queue item 1).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["SpeciesParams", "SEC_ROWS", "_P", "make_species_inner",
           "SpeciesKernel", "SPECIES_SHAPES", "species_flops_per_lane",
           "species_bytes_per_lane"]

_P = 2  # parents kept per species (reference: population_size=2, ik_evolution_2.cpp:137)

# packed per-variable secondary-fitness rows, in the reference's order
# (engine._secondary_rows); used once secondary goals are ported
SEC_ROWS = ("alpha", "beta", "gamma", "delta", "tbar", "mid", "hspan",
            "seed")

# (V, K) instances of csrc/species.cu (its SHAPES macro)
SPECIES_SHAPES = ((10, 1), (5, 1))

_MEMETIC_CODE = {"": 0, "q": 1, "l": 2}


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


def species_bytes_per_lane(sp: SpeciesParams) -> int:
    """Bytes per lane per launch, each input read once and each output
    written once: the TPU cost estimate's rows (bio2_step.py:472-473) plus
    the goal rows it leaves out (tips0, gpos, gquat, wpos, wrot: 16·K)."""
    V, K = sp.V, sp.K
    return 4 * (sp.gens * V * sp.C + sp.gens * sp.C + 4 * _P * V
                + V * K * 7 + 3 * V + 16 * K)


def make_species_inner(sp: SpeciesParams):
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
              span, cmin, cmax, noise, rates):
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
                f2 = f2p
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
                l1 = 0.0
                for v in range(V):
                    l1 = l1 + torch.abs(grad[v])
                # a true division (``float / tensor`` would multiply by a
                # reciprocal and round differently from the JAX body)
                scale = torch.full_like(l1, sp.h) / (l1 + 1e-12)
                gdir = grad * scale
                f1, _ = f_of(x - gdir)
                f3, _ = f_of(x + gdir)
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
    """The species step for one :class:`SpeciesParams`; call it on the
    ``(rows, N)`` tensors of :func:`make_species_inner`.

    ``SpeciesKernel.launches`` counts CUDA kernel launches over all
    instances; it is incremented only where the CUDA kernel is launched.
    """

    launches = 0

    def __init__(self, sp: SpeciesParams):
        if any(s + 4 > sp.V for s in sp.quat_slices):
            raise ValueError(f"quat_slices {sp.quat_slices} exceed V={sp.V}")
        self.sp = sp
        self.inner = make_species_inner(sp)
        V, K = sp.V, sp.K
        self.rows = (("genes", _P * V), ("grads", _P * V), ("tips0", 7 * K),
                     ("deltas", 7 * V * K), ("gpos", 3 * K), ("gquat", 4 * K),
                     ("wpos", K), ("wrot", K), ("span", V), ("cmin", V),
                     ("cmax", V))

    def __call__(self, genes, grads, tips0, deltas, gpos, gquat, wpos, wrot,
                 span, cmin, cmax, noise, rates):
        """One species step; returns ``(genes', grads')``."""
        args = (genes, grads, tips0, deltas, gpos, gquat, wpos, wrot, span,
                cmin, cmax, noise, rates)
        dev = genes.device
        if dev.type == "cpu":
            return self.inner(*args)
        if dev.type == "cuda":
            return self._launch(args)
        raise ValueError(f"the species step runs on cuda or cpu tensors, not {dev}")

    # ------------------------------------------------------------------
    def _launch(self, args):
        from .build import load

        sp = self.sp
        genes = args[0]
        dev = genes.device
        N = genes.shape[-1]

        def check(t, shape, name):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name}: want a contiguous float32 {shape} tensor on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")

        for t, (name, r) in zip(args, self.rows):
            check(t, (r, N), name)
        check(args[11], (sp.gens, sp.V, sp.C, N), "noise")
        check(args[12], (sp.gens, sp.C, N), "rates")

        lib = load("species")
        lib.species_has_shape.argtypes = [ctypes.c_int] * 2
        lib.species_has_shape.restype = ctypes.c_int
        if not lib.species_has_shape(sp.V, sp.K):
            raise ValueError(
                f"the species kernel is not instantiated for V={sp.V}, "
                f"K={sp.K} (SHAPES in csrc/species.cu; ROADMAP.md, port "
                "queue item 9)")
        qmask = 0
        for s in sp.quat_slices:
            qmask |= 1 << s
        genes_o, grads_o = torch.empty_like(genes), torch.empty_like(genes)
        fn = lib.species_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_uint]
                       + [ctypes.c_void_p] * 16)
        rc = fn(sp.V, sp.K, N, sp.gens, sp.C, sp.mem_iters,
                _MEMETIC_CODE[sp.memetic], sp.h, qmask,
                *(_ptr(t) for t in args), _ptr(genes_o), _ptr(grads_o),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"species launch failed: CUDA error {rc}")
        SpeciesKernel.launches += 1
        return genes_o, grads_o
