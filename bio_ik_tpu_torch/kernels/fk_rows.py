"""Row-level exact FK + linearizer over ``(1, N)`` lane rows.

Port of :mod:`bio_ik_tpu.kernels.fk_rows` (reference: src/
forward_kinematics.h:217-360 tree FK and :553-930 delta-frame build).
Every frame component is either a Python ``float`` (a constant of the
robot) or a ``(1, N)`` tensor row, so constant chain prefixes fold on the
host exactly as in the JAX package.  This plain version is the reference
for the FK inside the CUDA megastep kernel, which reads the same chain
through :meth:`FkRows.chain_arrays`.

Supported joint types: FIXED, REVOLUTE, PRISMATIC (+ mimic of an active
1-DOF joint).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..robot.model import RobotModel
from ..robot.urdf import FIXED, PRISMATIC, REVOLUTE

__all__ = ["FkRows", "supports_fullstep_chain", "MAX_LINKS"]

# largest link schedule the CUDA kernel's chain description holds
# (snake-32 needs 34); must equal MAX_LINKS in csrc/megastep.cu
MAX_LINKS = 40

# chain description: per-link ints and floats handed to the CUDA kernel
# (layout shared with csrc/megastep.cu)
SRC_NONE, SRC_ACTIVE, SRC_FIXED, SRC_CONST = 0, 1, 2, 3


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    )


def _qrot(q, v):
    # two-cross-product form (reference: quat_mul_vec, frame.h:108-149)
    qx, qy, qz, qw = q
    vx, vy, vz = v
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return (
        vx + qw * tx + (qy * tz - qz * ty),
        vy + qw * ty + (qz * tx - qx * tz),
        vz + qw * tz + (qx * ty - qy * tx),
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def supports_fullstep_chain(model: RobotModel, tip_idx: Sequence[int]) -> bool:
    """True when every joint on the tip chains is FIXED/REVOLUTE/PRISMATIC."""
    for li in model.link_schedule(tip_idx):
        if model.parent[li] < 0:
            continue
        if int(model.jtype[li]) not in (FIXED, REVOLUTE, PRISMATIC):
            return False
    return True


class FkRows:
    """Row-level FK for one (model, tips, active set).

    ``fixed_vars`` lists the global variable indices whose values must be
    provided as extra rows (chain joints that are neither active nor
    mimic-of-active), in chain order.
    """

    def __init__(self, model: RobotModel, tip_links: Sequence[str],
                 active_vars: Sequence[int]):
        self.model = model
        tip_idx = [model.link_index[t] for t in tip_links]
        if not supports_fullstep_chain(model, tip_idx):
            raise ValueError("chain has floating/planar joints")
        self.schedule = model.link_schedule(tip_idx)
        self.tip_idx = tip_idx
        active = list(active_vars)
        self.active = active
        aslot = {v: i for i, v in enumerate(active)}

        # per-link variable source: ("active", slot, f, off) |
        # ("fixed", fixed_row_index, f, off)
        self.fixed_vars: List[int] = []
        self.var_src = {}
        for li in self.schedule:
            if model.parent[li] < 0 or model.jtype[li] == FIXED:
                continue
            v = int(model.vstart[li])
            f, off = 1.0, 0.0
            if model.mimic_src[v] >= 0:
                f = float(model.mimic_factor[v])
                off = float(model.mimic_offset[v])
                v = int(model.mimic_src[v])
            if v in aslot:
                self.var_src[li] = ("active", aslot[v], f, off)
            else:
                if v not in self.fixed_vars:
                    self.fixed_vars.append(v)
                self.var_src[li] = ("fixed", self.fixed_vars.index(v), f, off)

        # moving joints that displace any tip → (link, active slot, factor)
        tip_anc = [set(model.ancestors(t)) for t in tip_idx]
        self.moving = []
        for li in self.schedule:
            src = self.var_src.get(li)
            if src is None or src[0] != "active":
                continue
            if any(li in anc for anc in tip_anc):
                self.moving.append((li, src[1], src[2]))
        self.tip_anc = tip_anc

    # ------------------------------------------------------------------
    def frames(self, xrows, fixed_rows):
        """Exact global frames ``{link: (pos3, quat4)}`` for every schedule
        link; ``xrows`` are the V active rows, ``fixed_rows`` the rows of
        :attr:`fixed_vars`."""
        m = self.model
        out = {}
        for li in self.schedule:
            if m.parent[li] < 0:
                out[li] = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))
                continue
            ppos, pquat = out[int(m.parent[li])]
            opos = tuple(float(c) for c in m.origin_pos[li])
            oquat = tuple(float(c) for c in m.origin_quat[li])
            rx, ry, rz = _qrot(pquat, opos)
            pre_pos = (ppos[0] + rx, ppos[1] + ry, ppos[2] + rz)
            pre_quat = _qmul(pquat, oquat)
            jt = int(m.jtype[li])
            if jt == FIXED:
                out[li] = (pre_pos, pre_quat)
                continue
            kind, idx, f, off = self.var_src[li]
            q = (xrows[idx] if kind == "active" else fixed_rows[idx])
            if f != 1.0 or off != 0.0:
                q = q * f + off
            ax, ay, az = (float(c) for c in m.axis[li])
            if jt == REVOLUTE:
                h = 0.5 * q
                s, c = torch.sin(h), torch.cos(h)
                jq = (ax * s, ay * s, az * s, c)
                out[li] = (pre_pos, _qmul(pre_quat, jq))
            else:  # PRISMATIC
                dx, dy, dz = _qrot(pre_quat, (ax * q, ay * q, az * q))
                out[li] = (
                    (pre_pos[0] + dx, pre_pos[1] + dy, pre_pos[2] + dz),
                    pre_quat,
                )
        return out

    def tips(self, frames):
        """Tip components per tip: list of (pos3, quat4)."""
        return [frames[t] for t in self.tip_idx]

    def deltas(self, frames):
        """Per-(active var, tip) delta frames ``d[v][t]`` → ``(dpos3,
        dquat4)`` or ``None`` (no dependency; reference:
        mutation_approx_mask, forward_kinematics.h:907-929).  Mimic factors
        are folded in (forward_kinematics.h:578-587)."""
        m = self.model
        V = len(self.active)
        T = len(self.tip_idx)
        d = [[None] * T for _ in range(V)]
        for li, slot, factor in self.moving:
            pj, qj = frames[li]
            ax = tuple(float(c) for c in m.axis[li])
            omega = _qrot(qj, ax)
            is_rev = int(m.jtype[li]) == REVOLUTE
            for t in range(T):
                if li not in self.tip_anc[t]:
                    continue
                tp, tq = frames[self.tip_idx[t]]
                if is_rev:
                    arm = (tp[0] - pj[0], tp[1] - pj[1], tp[2] - pj[2])
                    dpos = _cross(omega, arm)
                    dquat = _qmul((omega[0], omega[1], omega[2], 0.0), tq)
                    dquat = tuple(0.5 * c for c in dquat)
                else:
                    dpos = omega
                    dquat = (0.0, 0.0, 0.0, 0.0)
                if factor != 1.0:
                    dpos = tuple(factor * c for c in dpos)
                    dquat = tuple(factor * c for c in dquat)
                prev = d[slot][t]
                if prev is None:
                    d[slot][t] = (dpos, dquat)
                else:  # mimic fan-in onto the same active slot
                    pp, pq = prev
                    d[slot][t] = (
                        tuple(a + b for a, b in zip(pp, dpos)),
                        tuple(a + b for a, b in zip(pq, dquat)),
                    )
        return d

    # ------------------------------------------------------------------
    def chain_arrays(self):
        """The chain as the CUDA kernel reads it: ``(link_i (L, 6) int32,
        link_f (L, 19) float32, tip_slot (T,) int32)``.

        ``link_i`` rows are ``[parent_slot, jtype, src_kind, src_idx,
        tip_mask, pre_const]``: ``src_kind`` is one of ``SRC_*``
        (``SRC_CONST`` marks a link whose whole frame is a constant of the
        robot, computed here in float64 exactly as :meth:`frames` folds
        it); ``tip_mask`` has bit ``t`` set when the link is a moving joint
        that displaces tip ``t`` (its delta frame enters
        ``d[src_idx][t]``); ``pre_const`` marks a joint whose parent·origin
        frame is such a constant.  ``link_f`` rows are ``[origin_pos(3),
        origin_quat(4), axis(3), factor, offset, const_pos(3),
        const_quat(4)]``, the constant being the link's frame (SRC_CONST) or
        its pre-joint frame (pre_const).
        """
        m = self.model
        L = len(self.schedule)
        if L > MAX_LINKS:
            raise ValueError(f"{L} chain links exceed the kernel's {MAX_LINKS}")
        slot_of = {li: s for s, li in enumerate(self.schedule)}
        link_i = np.zeros((L, 6), np.int32)
        link_f = np.zeros((L, 19), np.float64)
        const_frame = {}
        moving = {li: slot for li, slot, _ in self.moving}
        for s, li in enumerate(self.schedule):
            par = int(m.parent[li])
            link_f[s, 0:3] = m.origin_pos[li]
            link_f[s, 3:7] = m.origin_quat[li]
            link_f[s, 7:10] = m.axis[li]
            link_f[s, 10:12] = (1.0, 0.0)
            link_i[s, 0] = slot_of[par] if par >= 0 else -1
            link_i[s, 1] = int(m.jtype[li])
            if par < 0:
                const_frame[li] = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))
            elif par in const_frame:
                ppos, pquat = const_frame[par]
                opos = tuple(float(c) for c in m.origin_pos[li])
                oquat = tuple(float(c) for c in m.origin_quat[li])
                r = _qrot(pquat, opos)
                pre = (tuple(a + b for a, b in zip(ppos, r)),
                       _qmul(pquat, oquat))
                if int(m.jtype[li]) == FIXED:
                    const_frame[li] = pre
                else:
                    # parent·origin folds on the host; the joint does not
                    link_i[s, 5] = 1
                    link_f[s, 12:15] = pre[0]
                    link_f[s, 15:19] = pre[1]
            if li in const_frame:
                link_i[s, 2] = SRC_CONST
                link_f[s, 12:15] = const_frame[li][0]
                link_f[s, 15:19] = const_frame[li][1]
                continue
            src = self.var_src.get(li)
            if src is None:
                continue
            kind, idx, f, off = src
            link_i[s, 2] = SRC_ACTIVE if kind == "active" else SRC_FIXED
            link_i[s, 3] = idx
            link_f[s, 10:12] = (f, off)
            if li in moving:
                link_i[s, 4] = sum(1 << t for t in range(len(self.tip_idx))
                                   if li in self.tip_anc[t])
        tip_slot = np.asarray([slot_of[t] for t in self.tip_idx], np.int32)
        return link_i, link_f.astype(np.float32), tip_slot
