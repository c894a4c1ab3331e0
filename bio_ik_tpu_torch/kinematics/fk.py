"""Batched forward kinematics.

Port of :mod:`bio_ik_tpu.kinematics.fk` (reference: src/
forward_kinematics.h:217-360).  ``make_fk`` builds ``fk(q_full (..., V))
→ Frame`` as a Python loop over the topologically ordered link schedule;
the leading batch dimensions carry the parallelism.  The JAX package's
scan/unroll split is a compile-time concern with no counterpart in eager
PyTorch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..math.frame import Frame
from ..math.quat import quat_from_axis_angle, quat_mul, quat_normalize, quat_rotate
from ..robot.model import RobotModel
from ..robot.urdf import FIXED, FLOATING, PLANAR, PRISMATIC, REVOLUTE

__all__ = ["make_fk", "make_link_frames_fn", "joint_frame", "LinkFrames"]


class LinkFrames(NamedTuple):
    """Global frames of every schedule link: ``pos (..., S, 3)``,
    ``quat (..., S, 4)``."""

    pos: torch.Tensor
    quat: torch.Tensor


def joint_frame(jtype: int, axis: np.ndarray, qvals) -> Frame:
    """Local joint transform for one joint given its variable slice
    (reference: RobotJointEvaluator::getJointFrame,
    forward_kinematics.h:89-135)."""
    dt, dev = qvals.dtype, qvals.device
    if jtype == REVOLUTE:
        ax = torch.as_tensor(axis, dtype=dt, device=dev)
        angle = qvals[..., 0]
        return Frame(pos=torch.zeros(angle.shape + (3,), dtype=dt, device=dev),
                     quat=quat_from_axis_angle(ax, angle))
    if jtype == PRISMATIC:
        ax = torch.as_tensor(axis, dtype=dt, device=dev)
        d = qvals[..., 0:1]
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=dev)
        return Frame(pos=ax * d, quat=ident.expand(d.shape[:-1] + (4,)))
    if jtype == FLOATING:
        return Frame(pos=qvals[..., 0:3], quat=quat_normalize(qvals[..., 3:7]))
    if jtype == PLANAR:
        x, y, theta = qvals[..., 0], qvals[..., 1], qvals[..., 2]
        pos = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
        z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
        return Frame(pos=pos, quat=quat_from_axis_angle(z_axis, theta))
    raise ValueError(f"unexpected joint type {jtype}")


def make_link_frames_fn(model: RobotModel, link_indices: Sequence[int]):
    """Build ``fn(q_full) → LinkFrames`` over the deduped ancestor schedule
    of ``link_indices``; also returns ``slot_of_link``."""
    schedule = model.link_schedule(link_indices)
    slot_of_link = {li: s for s, li in enumerate(schedule)}

    def fn(q):
        q = model.apply_mimic(q)
        dt, dev = q.dtype, q.device
        batch = q.shape[:-1]
        pos, quat = [], []
        for li in schedule:
            if model.parent[li] < 0:
                pos.append(torch.zeros(batch + (3,), dtype=dt, device=dev))
                quat.append(torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                                         device=dev).expand(batch + (4,)))
                continue
            s = slot_of_link[int(model.parent[li])]
            ppos, pquat = pos[s], quat[s]
            opos = torch.as_tensor(model.origin_pos[li], dtype=dt, device=dev)
            oquat = torch.as_tensor(model.origin_quat[li], dtype=dt, device=dev)
            pre_pos = ppos + quat_rotate(pquat, opos)
            pre_quat = quat_mul(pquat, oquat.expand_as(pquat))
            jt = int(model.jtype[li])
            if jt == FIXED:
                pos.append(pre_pos)
                quat.append(pre_quat)
                continue
            vs, vc = int(model.vstart[li]), int(model.vcount[li])
            jf = joint_frame(jt, model.axis[li], q[..., vs:vs + vc])
            pos.append(pre_pos + quat_rotate(pre_quat, jf.pos))
            quat.append(quat_mul(pre_quat, jf.quat))
        return LinkFrames(pos=torch.stack(pos, dim=-2),
                          quat=torch.stack(quat, dim=-2))

    return fn, slot_of_link


def make_fk(model: RobotModel, tip_links: Sequence[str],
            device=None) -> Callable:
    """Build ``fk(q_full (..., V)) → Frame`` with tips stacked on axis -2.

    ``device`` (default: the model's) is where the returned function
    expects ``q_full``; a tensor elsewhere raises."""
    dev = model.device if device is None else torch.device(device)
    tip_idx = [model.link_index[t] for t in tip_links]
    frames_fn, slot_of_link = make_link_frames_fn(model, tip_idx)
    tip_slots = [slot_of_link[t] for t in tip_idx]

    def fk(q_full):
        if q_full.device.type != dev.type:
            raise ValueError(
                f"make_fk was built for {dev}, got a tensor on "
                f"{q_full.device}")
        lf = frames_fn(q_full)
        return Frame(pos=lf.pos[..., tip_slots, :],
                     quat=lf.quat[..., tip_slots, :])

    return fk
