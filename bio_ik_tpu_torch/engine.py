"""Fused bio2 throughput engine: scenario batch × islands × species on the
kernel lane axis, fullstep tier.

Port of :mod:`bio_ik_tpu.engine`.  Solver state lives in the megastep's
``(rows, N)`` lane layout (N = batch·islands·species) across the whole
solve; each acceptance chunk (``steps_per_check`` steps) is one megastep
launch (the CUDA kernel on the card, its plain torch version on the CPU),
and plain tensor code does the lane layout, the winner reduction
(reference: ik_parallel.h:220-261) and the merge between chunks.

This slice carries the fullstep tier for pose-family goals.  Problems that
need the species tier (floating/planar chains) are rejected by
:meth:`FusedBio2Engine.supports` (ROADMAP.md, port queue item 3), and
``solve_until`` waits for item 2.

Randomness.  Per-scenario keys are ``(B, 2)`` integer tensors of 32-bit
words (the layout of a raw JAX ``PRNGKey``).  :func:`_scenario_salt` equals
the JAX engine's bit for bit; the per-chunk seed (:meth:`_chunk_seed`) and
the per-phase key fold (:func:`fold_in`) are integer hashes in place of
JAX's threefry, so streams differ from JAX while the salt contract holds:
identical keys reproduce bitwise and a fresh ``keys[i]`` changes scenario
i only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .interop import tree_map
from .kernels.bio2_megastep import Megastep
from .kernels.bio2_step import SpeciesParams, _P
from .kernels.fk_rows import FkRows, supports_fullstep_chain
from .math.frame import Frame

__all__ = ["FusedBio2Engine", "fold_in", "mix32"]

_S = 2   # species per island (reference: ik_evolution_2.cpp:141)
_C = 16
_MAX_FUSED_VARS = 40
_M32 = 0xFFFFFFFF

_MEMETIC_OF_MODE = {"bio2": "", "bio2_memetic": "q", "bio2_memetic_l": "l"}


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
    """Batched bio2 solve with the megastep in the hot loop."""

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
        self.sp = SpeciesParams(V=self.ctx.nvars, K=K, C=_C, gens=gens,
                                mem_iters=8, memetic=memetic)
        self.spc = max(1, min(cfg.steps_per_check, cfg.max_steps))
        self.nchecks = max(1, cfg.max_steps // self.spc)
        self.mega = Megastep(
            p.model, p.tip_links, p.active_vars, [g[2] for g in self.ginst],
            self.sp, n_steps=self.spc, gauss_mode=cfg.gauss_mode,
            inst_kind=self.inst_kind)
        self.fixed_vars = FkRows(p.model, p.tip_links, p.active_vars).fixed_vars

    # ------------------------------------------------------------------
    @staticmethod
    def supports(iksolver) -> Optional[str]:
        """None when the fused fullstep path applies, else the reason."""
        p = iksolver.problem
        if iksolver.config.mode not in _MEMETIC_OF_MODE:
            return f"mode {iksolver.config.mode!r} is not a fused bio2 family"
        if p.has_secondary:
            return ("secondary goals are not ported yet (ROADMAP.md, port "
                    "queue item 1)")
        if not p.primary:
            return "no primary goals"
        for grp in p.primary:
            if grp.kind not in ("position", "orientation", "pose"):
                return (f"goal kind {grp.kind!r} is not ported yet (ROADMAP.md, "
                        "port queue item 1)")
        model = p.model
        if not supports_fullstep_chain(
                model, [model.link_index[t] for t in p.tip_links]):
            return ("floating/planar chains need the species-tier kernel, not "
                    "ported yet (ROADMAP.md, port queue item 3)")
        if np.dtype(p.dtype) != np.float32:
            return "fused kernel is float32"
        if len(p.active_vars) > _MAX_FUSED_VARS:
            return f"{len(p.active_vars)} active variables exceed the unroll guard"
        return None

    # ------------------------------------------------------------------
    def _goal_rows(self, data, B):
        """Per-goal-instance kernel rows from the data dict: gpos (B, 3K),
        gquat (B, 4K), wpos/wrot (B, K), pose family (the JAX engine's
        ``_goal_rows`` without the non-pose kinds' gaux rows)."""
        gpos, gquat, wpos, wrot = [], [], [], []
        for gi, k, _slot, kind in self.ginst:
            gd = data["primary"][gi]
            w = gd["weight_sq"][..., k]
            zeros3 = torch.zeros(w.shape + (3,), dtype=w.dtype, device=w.device)
            ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=w.dtype,
                                 device=w.device).expand(w.shape + (4,))
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
        gpos_b, gquat_b, wpos_b, wrot_b = self._goal_rows(data, B)
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
        consts = (qfix, ls["gpos"], ls["gquat"], ls["wpos"], ls["wrot"],
                  ls["span"], ls["cmin"], ls["cmax"], amin, amax)
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
        (reference: ik_parallel.h:220-261): successes before failures, each
        ranked by fitness."""
        p = self.problem
        V, T, L = self.sp.V, p.ntips, self.islands * _S
        B = data["seed_active"].shape[0]
        M = B * L

        def per_lane(x):
            return x[:, None].expand((B, L) + x.shape[1:]).reshape(
                (M,) + x.shape[1:])

        data_bl = tree_map(per_lane, data)
        qa = sol_r[:, :M].T.reshape(M, V)
        tips = sol_tips_r[:, :M].T.reshape(M, T, 7)
        tf = Frame(pos=tips[..., 0:3], quat=tips[..., 3:7])
        ok = p.check_solution(tf, qa, data_bl).reshape(B, L)
        fit = sol_fit_r[:, :M].T.reshape(B, L)
        rank = fit
        any_ok = torch.any(ok, dim=1, keepdim=True)
        sel = torch.where(ok == any_ok, rank, float("inf"))
        i = torch.argmin(sel, dim=1)
        bi = torch.arange(B, device=i.device)
        qa = qa.reshape(B, L, V)
        return qa[bi, i], fit[bi, i], ok[bi, i], rank[bi, i]

    def _mega_result(self, best, data):
        from .api import IKResult

        qa_w, fit_w, ok_w, _ = best
        qa_w = self.iksolver._rewrap(qa_w, data["seed_active"])
        qfull_w = self.ctx.qfull(data["seed_full"], qa_w)
        return IKResult(q=qfull_w, success=ok_w, fitness=fit_w, qa=qa_w)

    # ------------------------------------------------------------------
    def _solve_batch(self, keys, data):
        state, consts, salt, best = self._mega_prep(keys, data)
        for c in range(self.nchecks):
            state = self._mega_once(c, salt, state, consts)
            best = self._merge(
                best, self._eval_lanes(state[3], state[4], state[5], data))
        return self._mega_result(best, data)

    def solve_batch(self, keys, data):
        return self._solve_batch(keys, data)

    def solve_until(self, key, data, timeout_s=None, max_checks=None):
        raise NotImplementedError(
            "latency mode is not ported yet (ROADMAP.md, port queue item 2)")
