"""Quaternion algebra on ``(..., 4)`` tensors, **xyzw** convention.

Port of :mod:`bio_ik_tpu.math.quat` (reference: include/bio_ik/frame.h:
108-238): every function is a torch op broadcastable over leading batch
dimensions.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "quat_identity",
    "quat_mul",
    "quat_conj",
    "quat_inv",
    "quat_rotate",
    "quat_norm_sq",
    "quat_normalize",
    "quat_normalize_fast",
    "quat_from_axis_angle",
    "quat_angle_shortest",
    "quat_dist_sq_double_cover",
    "quat_to_rotvec_wrapped",
    "cross",
]


def cross(a, b):
    """Cross product on the last axis, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_identity(shape=(), dtype=torch.float32, device=None):
    """Identity quaternion broadcast to ``shape + (4,)``."""
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    return q.expand(tuple(shape) + (4,))


def quat_mul(a, b):
    """Hamilton product ``a ⊗ b`` (reference: quat_mul_quat, frame.h:151-172)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q):
    """Conjugate (= inverse for unit quaternions; reference: frame.h:189-196)."""
    sign = torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)
    return q * sign


quat_inv = quat_conj


def quat_rotate(q, v):
    """Rotate ``v (..., 3)`` by unit ``q`` — two-cross-product form
    (reference: quat_mul_vec, frame.h:108-149)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_norm_sq(q):
    return torch.sum(q * q, dim=-1, keepdim=True)


def quat_normalize(q):
    return q / torch.sqrt(quat_norm_sq(q))


def quat_normalize_fast(q):
    """One Newton step toward unit norm (reference: normalizeFast,
    frame.h:231-238)."""
    return q * ((3.0 - quat_norm_sq(q)) * 0.5)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion from unit ``axis (..., 3)`` and ``angle (...)``
    (reference: forward_kinematics.h:89-112)."""
    half = 0.5 * angle
    s = torch.sin(half)
    c = torch.cos(half)
    return torch.cat([axis * s[..., None], c[..., None]], dim=-1)


def quat_angle_shortest(a, b):
    """Shortest-path angle in ``[0, π]`` (tf2 angleShortestPath, used by
    the acceptance test, problem.cpp:291,311)."""
    d = torch.abs(torch.sum(a * b, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, 0.0, 1.0))


def quat_dist_sq_double_cover(a, b):
    """``min(‖a−b‖², ‖a+b‖²)`` (reference: goal_types.h:119,172)."""
    d_minus = torch.sum(torch.square(a - b), dim=-1)
    d_plus = torch.sum(torch.square(a + b), dim=-1)
    return torch.minimum(d_minus, d_plus)


def quat_to_rotvec_wrapped(q, eps=1e-12):
    """Axis·angle with the reference's wrap: ``angle ∈ [0, 2π)`` then
    ``−2π`` above π (frame.h:246-253); zero-safe axis."""
    v = q[..., :3]
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(s[..., 0], q[..., 3])
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    axis = v / torch.clamp(s, min=eps)
    return axis * angle[..., None]
