"""Geometric Jacobian and first-order tip-frame linearizer.

Port of :mod:`bio_ik_tpu.kinematics.approx` (reference: src/
forward_kinematics.h:553-731 and 783-1234).  The delta-tensor build is
vectorized over joints and the mutation approximation is one contraction

    ``tips ≈ tips0 (T,7)  +  dq (N,V) · deltas (V, T·7)``.

As in the reference (forward_kinematics.h:1061-1233), approximated
quaternions are **not** renormalized.

Delta-frame math (forward_kinematics.h:827-853):

  * revolute joint, world axis ``ω`` through point ``p_j``:
      ``∂pos/∂q = ω × (p_tip − p_j)``,  ``∂quat/∂q = ½·(ω,0) ⊗ q_tip``
  * prismatic: ``∂pos/∂q = ω``, ``∂quat/∂q = 0``
  * other joint types (floating/planar): forward differences of exact FK
    (forward_kinematics.h:695-727)
  * mimic joints contribute factor-scaled columns to their source variable
    (forward_kinematics.h:578-587) through one static scatter matrix
    ``cols (T,J,7) · S (J,V)``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..math.frame import Frame
from ..math.quat import cross, quat_conj, quat_mul, quat_rotate, quat_to_rotvec_wrapped
from ..robot.model import RobotModel
from ..robot.urdf import PRISMATIC, REVOLUTE
from .fk import make_fk, make_link_frames_fn

__all__ = ["make_linearizer", "apply_deltas", "apply_deltas_single", "make_jacobian"]


class _JointCols:
    """Static structure shared by the linearizer and the Jacobian builder.

    Enumerates the "moving joints" J that can displace any tip: joints
    owning an active variable, plus mimic joints whose source is active.
    Builds the (T,J) dependency mask and the (J,V) mimic scatter matrix;
    ``fd_vars`` are the active-variable slots with no analytic column.
    """

    def __init__(self, model: RobotModel, tip_idx: List[int], active_vars: Sequence[int]):
        self.model = model
        self.active_vars = list(active_vars)
        var_slot = {v: i for i, v in enumerate(self.active_vars)}
        tip_anc = [set(model.ancestors(t)) for t in tip_idx]

        joints: List[int] = []        # link index of each moving joint
        target: List[int] = []        # active-var slot its column scatters to
        factor: List[float] = []
        self.fd_vars: List[int] = []

        for i, v in enumerate(self.active_vars):
            lv = int(model.var_link[v])
            jt = int(model.jtype[lv])
            if jt not in (REVOLUTE, PRISMATIC):
                self.fd_vars.append(i)
                continue
            if any(lv in anc for anc in tip_anc):
                joints.append(lv)
                target.append(i)
                factor.append(1.0)
        for m in model.mimic_vars:
            src = int(model.mimic_src[m])
            if src in var_slot:
                lm = int(model.var_link[m])
                if any(lm in anc for anc in tip_anc):
                    joints.append(lm)
                    target.append(var_slot[src])
                    factor.append(float(model.mimic_factor[m]))

        self.joints = joints
        J, V, T = len(joints), len(self.active_vars), len(tip_idx)
        self.scatter = np.zeros((J, V))
        for j, (t, f) in enumerate(zip(target, factor)):
            self.scatter[j, t] = f
        self.dep = np.zeros((T, J))
        for ti, anc in enumerate(tip_anc):
            for j, lj in enumerate(joints):
                self.dep[ti, j] = 1.0 if lj in anc else 0.0
        self.axis = model.axis[joints] if joints else np.zeros((0, 3))
        self.is_rev = np.array(
            [model.jtype[lj] == REVOLUTE for lj in joints], dtype=bool
        )


def _joint_cols(jc: _JointCols, lf, slots_j, tip_slots, dtype, want7: bool):
    """Per-(tip, joint) delta columns from a LinkFrames buffer.

    Returns ``cols (..., T, J, 7)`` when ``want7`` (linearizer: pos delta +
    quaternion derivative) else ``(..., T, J, 6)`` (Jacobian: pos delta +
    angular velocity)."""
    dev = lf.pos.device
    pj = lf.pos[..., slots_j, :]        # (..., J, 3)
    qj = lf.quat[..., slots_j, :]       # (..., J, 4)
    axis = torch.as_tensor(jc.axis, dtype=dtype, device=dev)
    omega = quat_rotate(qj, axis)       # (..., J, 3) world-frame joint axis

    tp = lf.pos[..., tip_slots, :]      # (..., T, 3)
    tq = lf.quat[..., tip_slots, :]     # (..., T, 4)

    arm = tp[..., :, None, :] - pj[..., None, :, :]             # (..., T, J, 3)
    omega_b = omega[..., None, :, :].expand(arm.shape)
    dpos_rev = cross(omega_b, arm)

    is_rev = torch.as_tensor(jc.is_rev, device=dev)[..., None]
    dpos = torch.where(is_rev, dpos_rev, omega_b)

    if want7:
        omega_q = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
        dquat_rev = 0.5 * quat_mul(omega_q[..., None, :, :],
                                   tq[..., :, None, :].expand(arm.shape[:-1] + (4,)))
        dquat = torch.where(is_rev, dquat_rev, torch.zeros_like(dquat_rev))
        cols = torch.cat([dpos, dquat], dim=-1)                 # (..., T, J, 7)
    else:
        drot = torch.where(is_rev, omega_b, torch.zeros_like(omega_b))
        cols = torch.cat([dpos, drot], dim=-1)                  # (..., T, J, 6)

    dep = torch.as_tensor(jc.dep, dtype=dtype, device=dev)[..., None]  # (T, J, 1)
    return cols * dep


def _setup(model, tip_links, active_vars):
    tip_idx = [model.link_index[t] for t in tip_links]
    frames_fn, slot_of_link = make_link_frames_fn(model, tip_idx)
    tip_slots = [slot_of_link[t] for t in tip_idx]
    jc = _JointCols(model, tip_idx, active_vars)
    slots_j = [slot_of_link[lj] for lj in jc.joints]
    fd_fk = make_fk(model, tip_links) if jc.fd_vars else None
    return frames_fn, tip_slots, jc, slots_j, fd_fk, list(active_vars)


def _fd_offset(model, var: int, eps: float, like):
    """``e`` with ``eps`` at full-vector variable ``var``, zero elsewhere."""
    e = torch.zeros(model.nvars, dtype=like.dtype, device=like.device)
    e[var] = eps
    return e


def make_linearizer(
    model: RobotModel,
    tip_links: Sequence[str],
    active_vars: Sequence[int],
    fd_eps: float = 1e-4,
) -> Callable:
    """Build ``linearize(q_full) → (tips0 (..., T, 7), deltas (..., T, V, 7))``.

    ``q_full (..., V_full)`` (mimics applied internally); ``V`` is
    ``len(active_vars)``.  Floating/planar variables get forward-difference
    columns ``(FK(q + ε·e_v) − tips0)/ε`` with ``ε = fd_eps``.
    """
    frames_fn, tip_slots, jc, slots_j, fd_fk, active = _setup(
        model, tip_links, active_vars)

    def linearize(q_full):
        dtype = q_full.dtype
        lf = frames_fn(q_full)
        tips0 = torch.cat([lf.pos[..., tip_slots, :], lf.quat[..., tip_slots, :]],
                          dim=-1)                                # (..., T, 7)
        cols = _joint_cols(jc, lf, slots_j, tip_slots, dtype, want7=True)
        scatter = torch.as_tensor(jc.scatter, dtype=dtype, device=q_full.device)
        deltas = torch.einsum("...tjd,jv->...tvd", cols, scatter)

        if jc.fd_vars:
            eps = torch.tensor(fd_eps, dtype=dtype, device=q_full.device)
            for i in jc.fd_vars:
                te = fd_fk(q_full + _fd_offset(model, active[i], fd_eps, q_full))
                te_packed = torch.cat([te.pos, te.quat], dim=-1)
                deltas[..., :, i, :] = (te_packed - tips0) / eps   # (..., T, 7)
        return tips0, deltas

    return linearize


def apply_deltas(tips0, deltas, dq):
    """Approximate tip frames for a population of gene deltas.

    ``tips0 (..., T, 7)``, ``deltas (..., T, V, 7)``, ``dq (..., N, V)`` →
    ``(..., N, T, 7)`` (reference analog: computeApproximateMutations,
    forward_kinematics.h:1061-1233).
    """
    return tips0[..., None, :, :] + torch.einsum("...tvd,...nv->...ntd", deltas, dq)


def apply_deltas_single(phen, deltas, var_slot, delta):
    """Single-variable update of an existing phenotype ``phen (..., T, 7)``:
    ``phen + deltas[..., :, var_slot, :] · delta`` (reference analog:
    computeApproximateMutation1, forward_kinematics.h:1198-1233)."""
    return phen + deltas[..., :, var_slot, :] * delta


def make_jacobian(
    model: RobotModel, tip_links: Sequence[str], active_vars: Sequence[int],
    fd_eps: float = 1e-4,
) -> Callable:
    """Build ``jac(q_full) → (tips0: Frame (..., T), J (..., T, 6, V))``.

    Geometric (twist) Jacobian in **world** coordinates: rows are
    ``[dpos(3), ω(3)]`` (reference analog: computeJacobian,
    forward_kinematics.h:599-731).  Variables without an analytic column
    (floating/planar) get forward-difference columns: ``dpos = Δp/ε`` and
    ``ω`` from the rotation vector of the relative quaternion
    ``q(x+ε)·q(x)⁻¹`` (forward_kinematics.h:695-727, frame.h:240-259).
    """
    frames_fn, tip_slots, jc, slots_j, fd_fk, active = _setup(
        model, tip_links, active_vars)

    def jac(q_full):
        dtype = q_full.dtype
        lf = frames_fn(q_full)
        tips0 = Frame(pos=lf.pos[..., tip_slots, :], quat=lf.quat[..., tip_slots, :])
        cols = _joint_cols(jc, lf, slots_j, tip_slots, dtype, want7=False)
        scatter = torch.as_tensor(jc.scatter, dtype=dtype, device=q_full.device)
        J = torch.einsum("...tjd,jv->...tdv", cols, scatter)    # (..., T, 6, V)

        if jc.fd_vars:
            eps = torch.tensor(fd_eps, dtype=dtype, device=q_full.device)
            for i in jc.fd_vars:
                te = fd_fk(q_full + _fd_offset(model, active[i], fd_eps, q_full))
                dpos = (te.pos - tips0.pos) / eps                    # (..., T, 3)
                rel = quat_mul(te.quat, quat_conj(tips0.quat))
                drot = quat_to_rotvec_wrapped(rel) / eps             # (..., T, 3)
                J[..., :, :, i] = torch.cat([dpos, drot], dim=-1)
        return tips0, J

    return jac
