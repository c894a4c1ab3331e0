"""Fused bio2 throughput engine: scenario batch × islands × species on the
kernel lane axis.

Port of :mod:`bio_ik_tpu.engine`.  Solver state lives in the kernels'
``(rows, N)`` lane layout (N = batch·islands·species) across the whole
solve, and plain tensor code does the lane layout, the winner reduction
(reference: ik_parallel.h:220-261) and the merge between acceptance
chunks.  Two kernel tiers, chosen from the chain:

  * **fullstep** — FIXED/REVOLUTE/PRISMATIC chains: each acceptance chunk
    (``steps_per_check`` steps: exact FK, linearization, generations,
    memetic, species sort, wipeout, incumbents) is one megastep launch
    (``csrc/megastep.cu`` on the card, its plain torch version on the CPU);
  * **species** — chains with floating or planar joints: every step
    linearizes at parent 0 in plain torch (``SolverContext.linearize``,
    forward differences for the floating/planar variables), runs one
    species-step launch (``csrc/species.cu`` / its plain version), then
    exact FK, fitness, incumbents, species sort and wipeout in plain torch
    (reference: ik_evolution_2.cpp:604-645).

Primary goals of the pose family run on both tiers, the eight other
in-kernel kinds (lookat, line, plane, max/min_distance, cone, direction,
side) on the fullstep tier (the rows of :meth:`_goal_rows`); joint-space
secondary goals run in-kernel on both tiers (the packed rows of
:meth:`_secondary_rows`: per-generation pre-selection and the combined
memetic line search).  ``solve_until`` waits for item 2.  On a card, a
problem whose kernel shape no CUDA source instantiates, or whose goal
kinds its instance does not evaluate, is rejected by :meth:`supports`
(item 9).

Randomness.  Per-scenario keys are ``(B, 2)`` integer tensors of 32-bit
words (the layout of a raw JAX ``PRNGKey``).  :func:`_scenario_salt` equals
the JAX engine's bit for bit and is XORed into every raw 32-bit word a
lane draws, so identical keys reproduce bitwise and a fresh ``keys[i]``
changes scenario i only.  Both tiers draw from one stream, counter-based
Philox4x32-10 keyed by the per-chunk seed (:meth:`_chunk_seed`) at counter
(lane, step within the chunk, generation, draw) — the per-phase key fold
(:func:`fold_in`) is an integer hash in place of JAX's threefry:

  * fullstep tier: the megastep kernel draws every word in-kernel;
  * species tier: the species kernel draws the children's noise, the
    rates and the pre-selection keeps in-kernel at the megastep's counters
    (``bio2_megastep.philox_draw`` is the plain version of both); the
    wipeout coin and restart genes of an island are the Philox wipe words
    of its second species' lane (generation word ``0xFFFFFFFF``, the words
    the megastep's wipeout reads), drawn in torch (:meth:`_species_stream`).

The JAX engine draws the species tier's words with ``jax.random.bits``
under split keys outside its kernel (engine.py:705-715); the streams differ.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .interop import tree_map
from .kernels.bio2_fullstep import AUX_KINDS, LINK_KINDS, POSE_KINDS
from .kernels.bio2_megastep import MEGASTEP_SOURCES, Megastep, philox_wipe
from .kernels.bio2_step import (SPECIES_SHAPES, SpeciesKernel, SpeciesParams, _P,
                                quat_mask)
from .kernels.fk_rows import FkRows, supports_fullstep_chain
from .math.frame import Frame
from .solvers.bio2 import quat_gene_slices

__all__ = ["FusedBio2Engine", "fold_in", "mix32"]

_S = 2   # species per island (reference: ik_evolution_2.cpp:141)
_C = 16
_WIPEOUT_P = 0.1  # reference: ik_evolution_2.cpp:632
_MAX_FUSED_VARS = 40
_M32 = 0xFFFFFFFF

_MEMETIC_OF_MODE = {"bio2": "", "bio2_memetic": "q", "bio2_memetic_l": "l"}

# secondary goal kind → in-kernel quadratic term (bio2_step.SEC_ROWS)
_SEC_TERM_OF = {
    "center_joints": "alpha",
    "regularization": "beta",
    "minimal_displacement": "beta",
    "avoid_joint_limits": "gamma",
    "joint_variable": "delta",
}
# primary kinds of the fused fitness (JAX engine.py:276-277)
_FUSED_KINDS = POSE_KINDS + LINK_KINDS
# per non-pose kind, the data entries its gpos, gaux and wrot rows carry
# (JAX engine.py:378-414)
_LINK_ROWS = {
    "lookat": ("target", "axis", None),
    "max_distance": ("target", None, "distance"),
    "min_distance": ("target", None, "distance"),
    "line": ("position", "direction", None),
    "plane": ("position", "normal", None),
    "direction": ("direction", "axis", None),
    "side": ("direction", "axis", None),
    "cone": ("position", "axis", "position_weight_sq"),
}


def _mul32(x, c: int):
    """Low 32 bits of ``x·c`` for int64 tensors of 32-bit values and a
    32-bit constant, without int64 overflow (16-bit split of ``c``)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x):
    """murmur3's fmix32 finalizer on int64 tensors of 32-bit values (or a
    Python int)."""
    if isinstance(x, int):
        x &= _M32
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & _M32
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & _M32
        return x ^ (x >> 16)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fold_in(keys, data: int):
    """Derive new ``(B, 2)`` key words from ``keys`` and an integer — the
    port's counterpart of ``jax.random.fold_in`` (not the same function):
    each new word hashes both old words and ``data``."""
    k = keys.to(torch.int64) & _M32
    d = mix32((int(data) * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    w0 = mix32(k[..., 0] ^ mix32(k[..., 1] ^ d))
    w1 = mix32(k[..., 1] ^ mix32(w0 ^ (d ^ 0x68E31DA4)))
    return torch.stack([w0, w1], dim=-1)


def _scenario_salt(keys):
    """Per-scenario 32-bit salts ``k0 ^ (k1·2654435761) mod 2³²`` from the
    ``(B, 2)`` key words — bit for bit the JAX engine's ``_scenario_salt``
    (int64 tensors holding uint32 values)."""
    k = keys.to(torch.int64) & _M32
    return k[..., 0] ^ _mul32(k[..., 1], 2654435761)


def _as_int32(u):
    """uint32 values held in int64 → the same bits as int32."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


class FusedBio2Engine:
    """Batched bio2 solve with a fused kernel in the hot loop."""

    def __init__(self, iksolver):
        reason = self.supports(iksolver)
        if reason is not None:
            raise ValueError(f"fused engine unsupported: {reason}")
        self.iksolver = iksolver
        self.problem = p = iksolver.problem
        self.ctx = iksolver.ctx
        self.config = cfg = iksolver.config
        self.islands = iksolver.islands
        self.device = p.device

        memetic = _MEMETIC_OF_MODE[cfg.mode]
        gens = 8 if memetic else 16
        # goal-instance table: one kernel row group per primary instance
        self.ginst = []  # (group_idx, instance, tip_slot, kind)
        for gi, grp in enumerate(p.primary):
            for k in range(grp.count):
                self.ginst.append((gi, k, int(grp.tip_slots[k]), grp.kind))
        K = len(self.ginst)
        self.inst_kind = [g[3] for g in self.ginst]
        self.has_aux = any(k in AUX_KINDS for k in self.inst_kind)
        model = p.model
        self.fullstep = supports_fullstep_chain(
            model, [model.link_index[t] for t in p.tip_links])
        # floating-joint quaternion genes are renormalized in the species
        # kernel; a fullstep chain has none
        self.sp = SpeciesParams(
            V=self.ctx.nvars, K=K, C=_C, gens=gens, mem_iters=8,
            memetic=memetic,
            quat_slices=tuple(quat_gene_slices(model, p.active_vars)))
        # joint-space secondary goals run in the kernels (pre-selection and
        # combined memetic, reference: ik_evolution_2.cpp:366-378, :459-537)
        self.sec_terms = tuple(sorted({_SEC_TERM_OF[grp.kind]
                                       for grp in p.secondary}))
        self.spc = max(1, min(cfg.steps_per_check, cfg.max_steps))
        self.nchecks = max(1, cfg.max_steps // self.spc)
        if self.fullstep:
            self.mega = Megastep(
                model, p.tip_links, p.active_vars, [g[2] for g in self.ginst],
                self.sp, n_steps=self.spc, gauss_mode=cfg.gauss_mode,
                sec_terms=self.sec_terms, inst_kind=self.inst_kind)
            self.fixed_vars = FkRows(model, p.tip_links, p.active_vars).fixed_vars
        else:
            self.kernel = SpeciesKernel(self.sp, self.sec_terms)

    # ------------------------------------------------------------------
    @staticmethod
    def supports(iksolver) -> Optional[str]:
        """None when a fused tier applies, else the reason."""
        p = iksolver.problem
        if iksolver.config.mode not in _MEMETIC_OF_MODE:
            return f"mode {iksolver.config.mode!r} is not a fused bio2 family"
        # joint-space secondary goals run on both tiers (JAX engine.py:278-287)
        for grp in p.secondary:
            if grp.kind not in _SEC_TERM_OF:
                return (f"secondary goal kind {grp.kind!r} not in the fused "
                        "secondary fitness")
        if not p.primary:
            return "no primary goals"
        model = p.model
        fullstep = supports_fullstep_chain(
            model, [model.link_index[t] for t in p.tip_links])
        for grp in p.primary:
            if grp.kind not in _FUSED_KINDS:
                return f"goal kind {grp.kind!r} not in the fused fitness"
            # the species tier keeps pose-shaped rows (JAX engine.py:295-300)
            if grp.kind not in POSE_KINDS and not fullstep:
                return ("non-pose primary goals need the fullstep kernel "
                        "(floating/planar chain)")
        if np.dtype(p.dtype) != np.float32:
            return "fused kernel is float32"
        V = len(p.active_vars)
        if V > _MAX_FUSED_VARS:
            return f"{V} active variables exceed the unroll guard"
        if p.device.type == "cuda":
            K = sum(grp.count for grp in p.primary)
            shape = (V, K, p.ntips)
            if fullstep and not any(shape in x for x in MEGASTEP_SOURCES.values()):
                have = ", ".join(f"csrc/{src}.cu {list(shapes)}"
                                 for src, shapes in MEGASTEP_SOURCES.items())
                return (f"the megastep kernel is not instantiated for "
                        f"(V, K, T) = {shape} ({have}; ROADMAP.md, port queue item 9)")
            if fullstep and shape in MEGASTEP_SOURCES["megastep"] and any(
                    grp.kind not in POSE_KINDS for grp in p.primary):
                return (f"the (V, K, T) = {shape} megastep instance evaluates the "
                        "pose family only (csrc/megastep.cu; the other kinds run "
                        "on the csrc/megastep_wide.cu and csrc/megastep_high.cu "
                        "instances; ROADMAP.md, port queue item 9)")
            qmask = quat_mask(quat_gene_slices(model, p.active_vars))
            if not fullstep and (V, K, qmask) not in SPECIES_SHAPES:
                return (f"the species kernel is not instantiated for (V, K) = "
                        f"{(V, K)} with quaternion mask {qmask} (csrc/species.cu "
                        f"has (V, K, mask) {list(SPECIES_SHAPES)}; ROADMAP.md, port "
                        "queue item 9)")
        return None

    # ------------------------------------------------------------------
    def _secondary_rows(self, data, B):
        """Packed per-variable secondary rows ``(B, 8·V)`` in
        :data:`bio2_step.SEC_ROWS` order, each secondary group's (per-
        scenario) weight² folded into the quadratic coefficients (JAX
        engine.py:310-349; the evaluators in problem.py are the source
        forms).  A joint_variable goal on an inactive variable adds only a
        constant and is dropped: every kernel use is offset-invariant."""
        p = self.problem
        V = self.sp.V
        dt = torch.float32
        dev = data["seed_active"].device
        vw = p.velocity_weights.to(dt)
        bnd = p.abounded.to(dt)
        zeros = torch.zeros((B, V), dtype=dt, device=dev)
        alpha, beta, gamma, delta, tsum = zeros, zeros, zeros, zeros, zeros
        for grp, gdata in zip(p.secondary, data["secondary"]):
            w2 = gdata["weight_sq"].to(dt)                         # (B, count)
            w2s = torch.sum(w2, dim=-1)[:, None]                   # (B, 1)
            if grp.kind == "center_joints":
                alpha = alpha + w2s * torch.square(vw * bnd)
            elif grp.kind == "regularization":
                beta = beta + w2s
            elif grp.kind == "minimal_displacement":
                beta = beta + w2s * torch.square(vw)
            elif grp.kind == "avoid_joint_limits":
                gamma = gamma + w2s * torch.square(vw * bnd)
            elif grp.kind == "joint_variable":
                slots = np.asarray(grp.static["slots"])
                act = slots >= 0
                if act.any():
                    asl = torch.as_tensor(slots[act], device=dev)
                    actt = torch.as_tensor(act, device=dev)
                    w2a = w2[:, actt]
                    tgt = gdata["target"].to(dt)[:, actt]
                    delta = delta.index_add(1, asl, w2a)
                    tsum = tsum.index_add(1, asl, w2a * tgt)
        tbar = torch.where(delta > 0, tsum / torch.clamp(delta, min=1e-30), 0.0)
        mid = p.amid.to(dt).expand(B, V)
        hspan = (p.aspan.to(dt) * 0.5).expand(B, V)
        seed = data["seed_active"].to(dt)
        return torch.cat([alpha, beta, gamma, delta, tbar, mid, hspan, seed], -1)

    # ------------------------------------------------------------------
    def _goal_rows(self, data, B):
        """Per-goal-instance kernel rows from the data dict (JAX
        engine.py:352-432): gpos (B, 3K), gquat (B, 4K), gaux (B, 3K),
        wpos/wrot (B, K).  Row reuse per kind (bio2_fullstep's link_goal):
        lookat and max/min_distance put the target in gpos, line and plane
        their anchor point, direction and side the world direction; gaux
        carries the link-local axis (lookat/direction/side/cone) or the line
        direction / plane normal; wrot doubles as the distance of
        max/min_distance and as cone's position weight, cone's gquat rows
        carry [direction, angle]; wpos carries the weight of every non-pose
        kind."""
        gpos, gquat, gaux, wpos, wrot = [], [], [], [], []
        for gi, k, _slot, kind in self.ginst:
            gd = data["primary"][gi]
            w = gd["weight_sq"][..., k]
            zeros3 = torch.zeros(w.shape + (3,), dtype=w.dtype, device=w.device)
            ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=w.dtype,
                                 device=w.device).expand(w.shape + (4,))
            if kind in LINK_KINDS:
                anchor, aux, scalar = _LINK_ROWS[kind]
                gpos.append(gd[anchor][..., k, :])
                gquat.append(torch.cat([gd["direction"][..., k, :],
                                        gd["angle"][..., k][..., None]], -1)
                             if kind == "cone" else ident)
                gaux.append(gd[aux][..., k, :] if aux else zeros3)
                wpos.append(w)
                wrot.append(gd[scalar][..., k] if scalar else torch.zeros_like(w))
                continue
            gaux.append(zeros3)
            gpos.append(gd["position"][..., k, :] if kind in ("position", "pose")
                        else zeros3)
            gquat.append(gd["orientation"][..., k, :]
                         if kind in ("orientation", "pose") else ident)
            if kind == "pose":
                wpos.append(w)
                wrot.append(w * gd["rotation_scale_sq"][..., k])
            elif kind == "position":
                wpos.append(w)
                wrot.append(torch.zeros_like(w))
            else:
                wpos.append(torch.zeros_like(w))
                wrot.append(w)
        return (
            torch.stack(gpos, -2).reshape(B, -1),
            torch.stack(gquat, -2).reshape(B, -1),
            torch.stack(gaux, -2).reshape(B, -1),
            torch.stack(wpos, -1),
            torch.stack(wrot, -1),
        )

    # ------------------------------------------------------------------
    def _lane_setup(self, keys, data):
        """(rows, lanes) layout prep: lane helpers, lane-broadcast bounds
        and goal rows, the seed state and its exact fitness.  Lanes are not
        padded: the kernel masks its own ragged last block, so only the
        species pairing (an even lane count) is required."""
        p, ctx = self.problem, self.ctx
        V, I, S = self.sp.V, self.islands, _S
        T = p.ntips
        B = keys.shape[0]
        M = B * I * S

        def to_lanes(x):
            """(B, I, S, R) → (R, M) — species fastest on lanes."""
            return x.reshape(M, -1).T.contiguous()

        def lane_goal(x):
            r = x.shape[-1]
            return to_lanes(x[:, None, None, :].expand(B, I, S, r))

        seed_active = data["seed_active"].to(torch.float32)      # (B, V)
        seed_full = data["seed_full"]                            # (B, Vfull)
        seed_bis = seed_active[:, None, None, :].expand(B, I, S, V)
        gpos_b, gquat_b, gaux_b, wpos_b, wrot_b = self._goal_rows(data, B)
        genes = to_lanes(seed_bis[..., None, :].expand(B, I, S, _P, V)
                         .reshape(B, I, S, _P * V))
        seed_tips_f = ctx.tips_frame(seed_full, seed_active)      # (B, T)
        f0 = p.fitness(torch.cat([seed_tips_f.pos, seed_tips_f.quat], -1),
                       seed_active, data)                         # (B,)
        salt_m = _scenario_salt(keys)[:, None].expand(B, I * S).reshape(M)

        def bounds(x):
            return x[:, None].expand(V, M).to(torch.float32).contiguous()

        return dict(
            B=B, M=M, T=T, to_lanes=to_lanes, lane_goal=lane_goal,
            seed_active=seed_active, seed_full=seed_full, seed_bis=seed_bis,
            span=bounds(p.aspan), cmin=bounds(p.aclip_min),
            cmax=bounds(p.aclip_max),
            gpos=lane_goal(gpos_b), gquat=lane_goal(gquat_b),
            gaux=lane_goal(gaux_b) if self.has_aux else None,
            wpos=lane_goal(wpos_b), wrot=lane_goal(wrot_b),
            genes=genes, grads=torch.zeros_like(genes),
            seed_tips_f=seed_tips_f, f0=f0,
            salt_row=_as_int32(salt_m)[None, :],                  # (1, M)
        )

    def _mega_prep(self, keys, data):
        """Megastep-path initial ``(state, consts, salt, best)``."""
        p = self.problem
        V, I, S = self.sp.V, self.islands, _S
        ls = self._lane_setup(keys, data)
        B, M, T = ls["B"], ls["M"], ls["T"]
        to_lanes = ls["to_lanes"]
        seed_tips_f, f0, seed_bis = ls["seed_tips_f"], ls["f0"], ls["seed_bis"]
        dev = f0.device

        fv = self.fixed_vars
        if fv:
            qfix = to_lanes(ls["seed_full"][:, None, None, fv].expand(
                B, I, S, len(fv))).to(torch.float32)
        else:
            qfix = torch.zeros((1, M), dtype=torch.float32, device=dev)
        amin = p.amin[:, None].expand(V, M).to(torch.float32).contiguous()
        amax = p.amax[:, None].expand(V, M).to(torch.float32).contiguous()
        seed_tips_b = torch.cat([seed_tips_f.pos, seed_tips_f.quat], -1)
        sfit_r = torch.full((1, M), float("inf"), dtype=torch.float32, device=dev)
        sol_r = to_lanes(seed_bis)
        sol_fit_r = to_lanes(f0[:, None, None, None].expand(B, I, S, 1))
        sol_tips_r = to_lanes(seed_tips_b.reshape(B, 1, 1, T * 7).expand(
            B, I, S, T * 7))
        best = self._eval_lanes(sol_r, sol_fit_r, sol_tips_r, data)
        state = (ls["genes"], ls["grads"], sfit_r, sol_r, sol_fit_r, sol_tips_r)
        consts = ((qfix, ls["gpos"], ls["gquat"]) + ((ls["gaux"],) if self.has_aux else ())
                  + (ls["wpos"], ls["wrot"], ls["span"], ls["cmin"], ls["cmax"],
                     amin, amax))
        if self.sec_terms:
            consts += (ls["lane_goal"](self._secondary_rows(data, B)),)
        return state, consts, ls["salt_row"], best

    def _chunk_seed(self, c: int) -> int:
        """Per-chunk 32-bit Philox seed: an integer hash of the static
        config seed and the chunk index (per-scenario keys enter through
        the salt row, per-lane independence through the lane counter)."""
        return mix32(mix32(self.config.seed ^ 0x5EED) ^ mix32(c + 1))

    def _mega_once(self, c: int, salt, state, consts):
        """One megastep launch (= ``steps_per_check`` solver steps)."""
        return self.mega(state, consts, seed=self._chunk_seed(c), salt=salt)

    @staticmethod
    def _merge(best, cand):
        b_qa, b_fit, b_ok, b_key = best
        qa, fit, ok, kk = cand
        take = (ok & ~b_ok) | ((ok == b_ok) & (kk < b_key))
        return (
            torch.where(take[..., None], qa, b_qa),
            torch.where(take, fit, b_fit),
            torch.where(take, ok, b_ok),
            torch.where(take, kk, b_key),
        )

    def _eval_lanes(self, sol_r, sol_fit_r, sol_tips_r, data):
        """Winner per scenario among all island × species lane incumbents
        (the megastep's ``(rows, lanes)`` layout)."""
        V, T, L = self.sp.V, self.problem.ntips, self.islands * _S
        B = data["seed_active"].shape[0]
        M = B * L
        return self._winner(sol_r[:, :M].T.reshape(B, L, V),
                            sol_fit_r[:, :M].T.reshape(B, L),
                            sol_tips_r[:, :M].T.reshape(B, L, T, 7), data)

    def _winner(self, qa, fit, tips, data):
        """Winner per scenario among ``L`` candidates — ``qa (B, L, V)``,
        ``fit (B, L)``, exact-FK ``tips (B, L, T, 7)`` — (reference:
        ik_parallel.h:220-261): successes before failures, each ranked by
        fitness (successes by primary + secondary when the problem has
        secondary goals).  Returns ``(qa, fit, ok, rank)`` of the winners."""
        p = self.problem
        B, L, V = qa.shape
        T = tips.shape[2]

        def per_cand(x):
            return x[:, None].expand((B, L) + x.shape[1:]).reshape(
                (B * L,) + x.shape[1:])

        t = tips.reshape(B * L, T, 7)
        qa_c, data_c = qa.reshape(B * L, V), tree_map(per_cand, data)
        ok = p.check_solution(Frame(pos=t[..., 0:3], quat=t[..., 3:7]), qa_c,
                              data_c).reshape(B, L)
        if p.has_secondary:
            # successes ranked by primary + secondary, failures by primary
            # (JAX engine.py:615-619)
            fsec = p.fitness_secondary(qa_c, data_c).reshape(B, L)
            rank = torch.where(ok, fit + fsec, fit)
        else:
            rank = fit
        any_ok = torch.any(ok, dim=1, keepdim=True)
        sel = torch.where(ok == any_ok, rank, float("inf"))
        i = torch.argmin(sel, dim=1)
        bi = torch.arange(B, device=i.device)
        return qa[bi, i], fit[bi, i], ok[bi, i], rank[bi, i]

    def _result(self, best, data):
        from .api import IKResult

        qa_w, fit_w, ok_w, _ = best
        qa_w = self.iksolver._rewrap(qa_w, data["seed_active"])
        qfull_w = self.ctx.qfull(data["seed_full"], qa_w)
        return IKResult(q=qfull_w, success=ok_w, fitness=fit_w, qa=qa_w)

    # ------------------------------------------------------------------
    # species tier (JAX engine.py:676-839)
    def _species_stream(self, c: int, i: int, salt_row):
        """Step ``i`` of acceptance chunk ``c``'s randomness on the species
        tier: the species kernel's Philox arguments (seed :meth:`_chunk_seed`
        of the chunk, the step within it, the ``(1, M)`` int32 salt row: the
        megastep tier's stream), and the wipeout coin ``(B, I)`` and restart
        genes ``(B, I, V)`` of each island — the Philox wipe words of its
        second species' lane, drawn at ``B·I`` lanes
        (:func:`bio2_megastep.philox_wipe`)."""
        seed = self._chunk_seed(c)
        I, V = self.islands, self.sp.V
        M = salt_row.shape[-1]
        lane = torch.arange(1, M, _S, device=salt_row.device,
                            dtype=torch.int64)[None]
        salt = salt_row[:, 1::_S].to(torch.int64) & _M32
        wipe_u, wipe_g = philox_wipe(seed, lane, salt, i, V)
        B = M // (I * _S)
        rng = dict(seed=seed, step=i, salt=salt_row, gauss_mode=self.config.gauss_mode)
        return rng, wipe_u.reshape(B, I), wipe_g.T.reshape(B, I, V)

    @staticmethod
    def _species_book(f, qa_bis, tips_bis, genes, grads, sfit, solution,
                      sol_fit, sol_tips, wipe_u, wipe_g, amin, amax):
        """Bookkeeping after one species step (JAX engine.py:736-784):
        incumbent update from both species, species sort, wipeout of the
        stagnant non-best species.  ``f``/``sfit (B, I, S)`` exact fitness
        now and before, ``qa_bis (B, I, S, V)``, ``tips_bis (B, I, S, 7T)``,
        ``genes``/``grads (P·V, M)``, incumbents ``solution (B, I, V)``,
        ``sol_fit (B, I)``, ``sol_tips (B, I, T, 7)``.  Returns the new
        ``(genes, grads, sfit, solution, sol_fit, sol_tips)``."""
        B, I, S = f.shape
        V = qa_bis.shape[-1]
        improved = f != sfit

        # incumbent from the better species of each island (reference
        # :640-644 after the sort — the per-island min)
        s_best = torch.argmin(f, dim=-1, keepdim=True)               # (B, I, 1)
        f_best = f.gather(-1, s_best)[..., 0]
        better = f_best < sol_fit

        def take(x):
            idx = s_best[..., None].expand(B, I, 1, x.shape[-1])
            return x.gather(2, idx)[:, :, 0]

        solution = torch.where(better[..., None], take(qa_bis), solution)
        sol_tips = torch.where(better[..., None, None],
                               take(tips_bis).reshape(sol_tips.shape), sol_tips)
        sol_fit = torch.where(better, f_best, sol_fit)

        # species sort (S = 2 compare-swap; reference :617)
        swap = f[..., 1] < f[..., 0]

        def sswap(x):
            xr = x.reshape(-1, B, I, S)
            return torch.where(swap[None, :, :, None], xr.flip(-1), xr)

        genes, grads = sswap(genes), sswap(grads)
        f = torch.where(swap[..., None], f.flip(-1), f)
        improved = torch.where(swap[..., None], improved.flip(-1), improved)

        # wipeout of the stagnant non-best species (reference :620-637)
        wipe = ((wipe_u < _WIPEOUT_P) | ~improved[..., 1])[None, None]
        rand = (amin + wipe_g * (amax - amin)).permute(2, 0, 1)[None]  # (1,V,B,I)
        gr = genes.reshape(_P, V, B, I, S)
        gr[..., 1] = torch.where(wipe, rand, gr[..., 1])
        rr = grads.reshape(_P, V, B, I, S)
        rr[..., 1] = torch.where(wipe, 0.0, rr[..., 1])
        return (gr.reshape(_P * V, -1), rr.reshape(_P * V, -1), f, solution,
                sol_fit, sol_tips)

    def _species_solve(self, keys, data, draws=None):
        """Species-tier solve.  ``draws(step) → (noise, rates, wipe_u,
        wipe_g[, keeps])`` replaces the engine's own Philox stream
        (:meth:`_species_stream`) by noise tensors, for tests."""
        p, ctx = self.problem, self.ctx
        V, K, I, S = self.sp.V, self.sp.K, self.islands, _S
        ls = self._lane_setup(keys, data)
        B, M, T = ls["B"], ls["M"], ls["T"]

        def per_lane(n):
            def f(x):
                return x[:, None].expand((B, n) + x.shape[1:]).reshape(
                    (B * n,) + x.shape[1:])
            return f

        data_m = tree_map(per_lane(I * S), data)
        seed_full_m = data_m["seed_full"]
        tip_slots = [g[2] for g in self.ginst]
        seed_tips = torch.cat([ls["seed_tips_f"].pos, ls["seed_tips_f"].quat], -1)
        salt_row = ls["salt_row"]
        sec_rows = (ls["lane_goal"](self._secondary_rows(data, B))
                    if self.sec_terms else None)
        amin, amax = p.amin.to(torch.float32), p.amax.to(torch.float32)
        genes, grads = ls["genes"], ls["grads"]
        sfit = torch.full((B, I, S), float("inf"), dtype=torch.float32,
                          device=genes.device)
        solution = ls["seed_bis"][..., 0, :]                        # (B, I, V)
        sol_fit = ls["f0"][:, None].expand(B, I)
        sol_tips = seed_tips[:, None].expand(B, I, T, 7)

        def eval_islands():
            return self._winner(solution, sol_fit, sol_tips, data)

        best = eval_islands()
        for c in range(self.nchecks):
            for i in range(self.spc):
                if draws is None:
                    rng, wipe_u, wipe_g = self._species_stream(c, i, salt_row)
                else:
                    noise, rates, wipe_u, wipe_g, *keeps = draws(c * self.spc + i)
                    rng = dict(noise=noise, rates=rates,
                               keeps=keeps[0] if keeps else None)
                # linearize at parent 0 (reference :341-346)
                tips0_f, deltas_f = ctx.linearize(ctx.qfull(seed_full_m, genes[:V].T))
                tips0 = tips0_f[:, tip_slots].reshape(M, K * 7).T.contiguous()
                deltas = (deltas_f[:, tip_slots].transpose(1, 2)
                          .reshape(M, V * K * 7).T.contiguous())
                genes, grads = self.kernel(
                    genes, grads, tips0, deltas, ls["gpos"], ls["gquat"],
                    ls["wpos"], ls["wrot"], ls["span"], ls["cmin"], ls["cmax"],
                    sec=sec_rows, **rng)
                del rng, tips0, deltas, tips0_f, deltas_f
                # exact FK and fitness of the new parent 0
                qa_new = genes[:V].T
                tips_m = ctx.tips_packed(seed_full_m, qa_new)       # (M, T, 7)
                f = p.fitness(tips_m, qa_new, data_m).reshape(B, I, S)
                genes, grads, sfit, solution, sol_fit, sol_tips = self._species_book(
                    f, qa_new.reshape(B, I, S, V), tips_m.reshape(B, I, S, T * 7),
                    genes, grads, sfit, solution, sol_fit, sol_tips, wipe_u,
                    wipe_g, amin, amax)
            best = self._merge(best, eval_islands())
        return self._result(best, data)

    # ------------------------------------------------------------------
    def _solve_batch(self, keys, data):
        if not self.fullstep:
            return self._species_solve(keys, data)
        state, consts, salt, best = self._mega_prep(keys, data)
        for c in range(self.nchecks):
            state = self._mega_once(c, salt, state, consts)
            best = self._merge(
                best, self._eval_lanes(state[3], state[4], state[5], data))
        return self._result(best, data)

    def solve_batch(self, keys, data):
        return self._solve_batch(keys, data)

    def solve_until(self, key, data, timeout_s=None, max_checks=None):
        raise NotImplementedError(
            "latency mode is not ported yet (ROADMAP.md, port queue item 2)")
