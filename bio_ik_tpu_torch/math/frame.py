"""Rigid-transform ("frame") algebra on batched ``(pos, quat)`` pairs.

Port of :mod:`bio_ik_tpu.math.frame` (reference: include/bio_ik/frame.h:
51-259).  A :class:`Frame` is a named pair ``pos (..., 3)``,
``quat (..., 4)`` xyzw; every operation broadcasts over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .quat import (
    quat_conj,
    quat_identity,
    quat_mul,
    quat_normalize_fast,
    quat_rotate,
    quat_to_rotvec_wrapped,
)

__all__ = ["Frame", "frame_identity", "frame_mul", "frame_inv", "frame_change",
           "frame_apply", "frame_twist", "frame_pack", "frame_unpack"]


class Frame(NamedTuple):
    """Position + unit quaternion transform. Leading dims are batch dims."""

    pos: torch.Tensor   # (..., 3)
    quat: torch.Tensor  # (..., 4) xyzw

    def __matmul__(self, other: "Frame") -> "Frame":
        return frame_mul(self, other)

    @property
    def batch_shape(self):
        return self.pos.shape[:-1]


def frame_identity(shape=(), dtype=torch.float32, device=None) -> Frame:
    return Frame(
        pos=torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device),
        quat=quat_identity(shape, dtype=dtype, device=device),
    )


def frame_mul(a: Frame, b: Frame) -> Frame:
    """Compose ``a · b`` (reference: concat, frame.h:174-181)."""
    return Frame(pos=a.pos + quat_rotate(a.quat, b.pos),
                 quat=quat_mul(a.quat, b.quat))


def frame_inv(f: Frame) -> Frame:
    """Inverse transform (reference: frame.h:198-216)."""
    qc = quat_conj(f.quat)
    return Frame(pos=-quat_rotate(qc, f.pos), quat=qc)


def frame_change(a: Frame, b: Frame, c: Frame) -> Frame:
    """``a · b⁻¹ · c`` (reference: change(), frame.h:204-209)."""
    return frame_mul(frame_mul(a, frame_inv(b)), c)


def frame_apply(f: Frame, points):
    """Transform point(s) ``(..., 3)`` by frame(s)."""
    return f.pos + quat_rotate(f.quat, points)


def frame_twist(a: Frame, b: Frame):
    """6-twist ``[vel, rot]`` of ``a⁻¹ · b`` (reference: frameTwist,
    frame.h:240-259)."""
    rel = frame_mul(frame_inv(a), b)
    return torch.cat([rel.pos, quat_to_rotvec_wrapped(rel.quat)], dim=-1)


def frame_pack(f: Frame):
    """Pack to ``(..., 7)`` = ``[pos, quat]``."""
    return torch.cat([f.pos, f.quat], dim=-1)


def frame_unpack(arr, renormalize: bool = False) -> Frame:
    """Unpack ``(..., 7)``; optionally fast-renormalize the quaternion."""
    q = arr[..., 3:7]
    if renormalize:
        q = quat_normalize_fast(q)
    return Frame(pos=arr[..., 0:3], quat=q)
