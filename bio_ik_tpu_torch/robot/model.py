"""Compile a parsed URDF into an array-resident robot model.

Port of :mod:`bio_ik_tpu.robot.model`.  Replaces the reference's MoveIt
``RobotModel`` + ``RobotInfo`` (reference: include/bio_ik/robot_info.h:
46-125) with plain numpy arrays for the static kinematic structure (read
on the host to build FK loops and the kernel's chain description) plus
torch tensors on the model's device for the per-variable bounds.

Layout decisions (shared with the JAX package):
  * links are re-indexed topologically: ``parent[i] < i`` for every non-root
    link, so FK is a single forward pass over link index.
  * each link owns exactly its parent joint's data (type, origin, axis,
    variable span) — there is no separate joint table.
  * variables follow MoveIt's convention: one per 1-DOF joint, 7 for
    floating (x y z qx qy qz qw), 3 for planar (x y θ); mimic joints have
    variables that are overwritten from their source before FK.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .urdf import FIXED, FLOATING, PLANAR, PRISMATIC, REVOLUTE, UrdfRobot, load_urdf, parse_urdf

__all__ = ["RobotModel", "VariableBounds"]

_TWO_PI = 2.0 * math.pi


def _rpy_to_quat(r, p, y):
    """xyzw quaternion from URDF fixed-axis rpy (host-side, float64)."""
    hr, hp, hy = 0.5 * r, 0.5 * p, 0.5 * y
    sr, cr = math.sin(hr), math.cos(hr)
    sp, cp = math.sin(hp), math.cos(hp)
    sy, cy = math.sin(hy), math.cos(hy)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dtype=np.float64,
    )


@dataclass
class VariableBounds:
    """Device-resident per-variable bounds (reference: robot_info.h:46-125)."""

    min: torch.Tensor        # (V,) lower position bound (finite; ±π for continuous)
    max: torch.Tensor        # (V,) upper position bound
    clip_min: torch.Tensor   # (V,) clamp bound; ±inf when position-unbounded
    clip_max: torch.Tensor   # (V,)
    span: torch.Tensor       # (V,) max−min, sanitized to 1 if non-finite
    max_velocity: torch.Tensor      # (V,)
    max_velocity_rcp: torch.Tensor  # (V,) 1/max_velocity or 0

    def clip(self, q):
        return torch.clamp(q, self.clip_min, self.clip_max)


class RobotModel:
    """Static kinematic structure + bounds compiled from a URDF."""

    def __init__(self, urdf: UrdfRobot, dtype=np.float32, base_dir=None,
                 device=None):
        self.name = urdf.name
        self.dtype = dtype
        self.device = resolve_device(device)
        self.torch_dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        # directory for resolving relative mesh filenames in collision
        # elements (set by from_urdf_file)
        self.base_dir = base_dir

        # ---- topological re-indexing (root = link 0) --------------------
        joint_by_child: Dict[str, int] = {}
        children: Dict[str, List[str]] = {name: [] for name in urdf.links}
        for ji, j in enumerate(urdf.joints):
            if j.child in joint_by_child:
                raise ValueError(f"link {j.child} has multiple parent joints")
            joint_by_child[j.child] = ji
            children[j.parent].append(j.child)

        root = urdf.root_link
        order: List[str] = []
        stack = [root]
        while stack:
            name = stack.pop()
            order.append(name)
            # reversed → children visited in document order
            stack.extend(reversed(children[name]))
        if len(order) != len(urdf.links):
            raise ValueError("URDF link graph is not a connected tree")

        self.link_names: List[str] = order
        self.link_index: Dict[str, int] = {n: i for i, n in enumerate(order)}
        L = len(order)

        # ---- per-link joint arrays --------------------------------------
        self.parent = np.full(L, -1, dtype=np.int64)
        self.jtype = np.zeros(L, dtype=np.int64)          # FIXED for root
        self.origin_pos = np.zeros((L, 3), dtype=np.float64)
        self.origin_quat = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (L, 1))
        self.axis = np.tile(np.array([1.0, 0.0, 0.0]), (L, 1))
        self.vstart = np.full(L, -1, dtype=np.int64)
        self.vcount = np.zeros(L, dtype=np.int64)
        self.joint_names: List[Optional[str]] = [None] * L
        self.joint_index: Dict[str, int] = {}             # joint name → link idx
        self.masses = np.zeros(L, dtype=np.float64)
        self.coms = np.zeros((L, 3), dtype=np.float64)

        self.collisions: Dict[str, list] = {}
        for name in order:
            li = self.link_index[name]
            link = urdf.links[name]
            self.masses[li] = link.mass
            self.coms[li] = link.com
            if link.collisions:
                self.collisions[name] = list(link.collisions)

        # ---- variable allocation (topological joint order) --------------
        var_names: List[str] = []
        var_link: List[int] = []       # owning link (child of the joint)
        v_min: List[float] = []
        v_max: List[float] = []
        v_bounded: List[bool] = []
        v_vel: List[float] = []
        v_revolute: List[bool] = []
        v_prismatic: List[bool] = []

        def add_var(name, lo, hi, bounded, vel, rev=False, prism=False):
            var_names.append(name)
            var_link.append(li)
            v_min.append(lo)
            v_max.append(hi)
            v_bounded.append(bounded)
            v_vel.append(vel)
            v_revolute.append(rev)
            v_prismatic.append(prism)

        mimic_pairs: List[Tuple[int, str, float, float]] = []  # (var, src joint, mult, off)

        for name in order[1:]:
            ji = joint_by_child[name]
            j = urdf.joints[ji]
            li = self.link_index[name]
            self.parent[li] = self.link_index[j.parent]
            self.jtype[li] = j.type
            self.origin_pos[li] = j.origin_xyz
            self.origin_quat[li] = _rpy_to_quat(*j.origin_rpy)
            self.axis[li] = j.axis
            self.joint_names[li] = j.name
            self.joint_index[j.name] = li
            self.vstart[li] = len(var_names)

            if j.type == REVOLUTE:
                # continuous = revolute with span ≥ 2π → position-unbounded
                # (reference: robot_info.h:82-90)
                bounded = not (j.continuous or (j.upper - j.lower) >= _TWO_PI * 0.9999)
                add_var(j.name, j.lower, j.upper, bounded, j.velocity, rev=True)
            elif j.type == PRISMATIC:
                add_var(j.name, j.lower, j.upper, True, j.velocity, prism=True)
            elif j.type == FLOATING:
                for sfx in ("x", "y", "z"):
                    add_var(f"{j.name}/trans_{sfx}", -1.0, 1.0, False, j.velocity)
                for sfx in ("x", "y", "z", "w"):
                    add_var(f"{j.name}/rot_{sfx}", -1.0, 1.0, False, j.velocity)
            elif j.type == PLANAR:
                add_var(f"{j.name}/x", -1.0, 1.0, False, j.velocity)
                add_var(f"{j.name}/y", -1.0, 1.0, False, j.velocity)
                add_var(f"{j.name}/theta", -math.pi, math.pi, False, j.velocity)
            elif j.type == FIXED:
                self.vstart[li] = -1
            self.vcount[li] = len(var_names) - max(self.vstart[li], 0) if self.vstart[li] >= 0 else 0

            if j.mimic_joint is not None:
                if j.type not in (REVOLUTE, PRISMATIC):
                    raise ValueError(f"mimic only supported on 1-DOF joints ({j.name})")
                mimic_pairs.append((self.vstart[li], j.mimic_joint, j.mimic_multiplier, j.mimic_offset))

        self.var_names = var_names
        self.var_index: Dict[str, int] = {n: i for i, n in enumerate(var_names)}
        self.var_link = np.asarray(var_link, dtype=np.int64)
        V = len(var_names)

        # ---- mimic propagation table ------------------------------------
        self.mimic_src = np.full(V, -1, dtype=np.int64)
        self.mimic_factor = np.zeros(V, dtype=np.float64)
        self.mimic_offset = np.zeros(V, dtype=np.float64)
        self.mimic_vars: List[int] = []
        for var, src_joint, mult, off in mimic_pairs:
            src_li = self.joint_index.get(src_joint)
            if src_li is None:
                raise ValueError(f"mimic source joint {src_joint!r} not found")
            src_var = int(self.vstart[src_li])
            if self.mimic_src[src_var] >= 0:
                raise ValueError("chained mimic joints are not supported")
            self.mimic_src[var] = src_var
            self.mimic_factor[var] = mult
            self.mimic_offset[var] = off
            self.mimic_vars.append(var)

        # ---- bounds (reference: robot_info.h ctor) ----------------------
        mn = np.asarray(v_min, dtype=np.float64)
        mx = np.asarray(v_max, dtype=np.float64)
        bounded = np.asarray(v_bounded, dtype=bool)
        span = mx - mn
        span = np.where(np.isfinite(span) & (span >= 0), span, 1.0)
        vel = np.asarray(v_vel, dtype=np.float64)
        inf = np.inf
        self._np_bounds = dict(
            min=mn, max=mx,
            clip_min=np.where(bounded, mn, -inf),
            clip_max=np.where(bounded, mx, +inf),
            span=span,
            max_velocity=vel,
            max_velocity_rcp=np.where(vel > 0, 1.0 / np.maximum(vel, 1e-300), 0.0),
        )
        self.var_is_revolute = np.asarray(v_revolute, dtype=bool)
        self.var_is_prismatic = np.asarray(v_prismatic, dtype=bool)

        self.bounds = VariableBounds(
            **{k: torch.as_tensor(v.astype(dtype), device=self.device)
               for k, v in self._np_bounds.items()}
        )

    # -------------------------------------------------------------- API --
    @classmethod
    def from_urdf_file(cls, path: str, dtype=np.float32,
                       device=None) -> "RobotModel":
        import os

        return cls(load_urdf(path), dtype=dtype,
                   base_dir=os.path.dirname(os.path.abspath(path)),
                   device=device)

    @classmethod
    def from_urdf_string(cls, xml_text: str, dtype=np.float32,
                         device=None) -> "RobotModel":
        return cls(parse_urdf(xml_text), dtype=dtype, device=device)

    @property
    def nlinks(self) -> int:
        return len(self.link_names)

    @property
    def nvars(self) -> int:
        return len(self.var_names)

    def _resolve_mesh_path(self, filename: str) -> str:
        """Resolve a URDF mesh filename: absolute paths pass through;
        ``package://<pkg>/rest`` and plain relative paths resolve against
        the URDF file's directory (best effort without a ROS package
        index — the common single-package layout)."""
        import os

        if filename.startswith("package://"):
            rest = filename[len("package://"):]
            filename = rest.split("/", 1)[1] if "/" in rest else rest
        if os.path.isabs(filename):
            return filename
        if self.base_dir is None:
            raise ValueError(
                f"cannot resolve relative mesh path {filename!r}: model "
                "was not loaded from a file (no base directory)")
        return os.path.join(self.base_dir, filename)

    def collision_points(self, link_name: str, ring: int = 8,
                         sphere_points: int = 42) -> np.ndarray:
        """Convex support point cloud of the link's URDF collision
        primitives, in link coordinates — the counterpart of the
        reference's FCL-derived TouchGoal collision geometry
        (reference: goal_types.cpp:45-228, where convex meshes/
        primitives come from MoveIt's collision model).

        Boxes contribute their 8 corners (exact support set), cylinders
        two ``ring``-point end rings (chordal approximation), spheres a
        ``sphere_points`` Fibonacci sampling of the surface.  Meshes
        (STL, ``<mesh filename=...>``) are loaded and reduced to their
        convex-hull vertex set — the EXACT support set of the hull,
        matching the reference's FCL convex-mesh handling
        (goal_types.cpp:45-228; its support-vertex hill-climb over hull
        edges returns the same extreme vertex a min/max over hull
        vertices does).  Shape origins and mesh scales are applied.
        Raises if the link has no collision geometry.
        """
        pts, _ = self._collision_pointsets(link_name, ring, sphere_points,
                                           sphere_as_center=False)
        return pts

    def collision_support(self, link_name: str, ring: int = 16
                          ) -> "tuple[np.ndarray, np.ndarray]":
        """``(points (N,3), radii (N,))`` support set with per-point
        radii: the shape's support along any direction ``d`` is
        ``max_i(points_i·d + radii_i)``.  Spheres contribute ONE center
        point with ``radius=r`` — EXACT support (the reference's FCL
        sphere support, goal_types.cpp:45-228) instead of
        ``collision_points``'s surface sampling; boxes/meshes keep their
        exact vertex sets (radius 0); cylinders remain two chordal end
        rings (their direction-dependent support has no per-point-radius
        form — ``ring=16`` bounds the error at ``r·(1−cos(π/16)) ≈
        0.019·r``).  This is what the TouchGoal evaluator consumes."""
        return self._collision_pointsets(link_name, ring, 0,
                                         sphere_as_center=True)

    def _collision_pointsets(self, link_name, ring, sphere_points,
                             sphere_as_center):
        shapes = self.collisions.get(link_name)
        if not shapes:
            raise ValueError(
                f"link {link_name!r} has no collision geometry "
                "in the URDF (TouchGoal needs explicit `points` for it)"
            )
        out = []
        radii = []
        for s in shapes:
            rad = 0.0
            if s.shape == "box":
                sx, sy, sz = (d / 2.0 for d in s.size)
                pts = np.array([(x, y, z)
                                for x in (-sx, sx)
                                for y in (-sy, sy)
                                for z in (-sz, sz)])
            elif s.shape == "cylinder":
                r, ln = s.size
                ang = 2.0 * np.pi * np.arange(ring) / ring
                circ = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
                pts = np.concatenate([
                    np.concatenate([circ, np.full((ring, 1), z)], axis=-1)
                    for z in (-ln / 2.0, ln / 2.0)
                ])
            elif s.shape == "sphere":
                (r,) = s.size
                if sphere_as_center:
                    pts = np.zeros((1, 3))
                    rad = r
                else:
                    i = np.arange(sphere_points, dtype=np.float64) + 0.5
                    phi = np.arccos(1.0 - 2.0 * i / sphere_points)
                    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
                    pts = r * np.stack([
                        np.cos(theta) * np.sin(phi),
                        np.sin(theta) * np.sin(phi),
                        np.cos(phi),
                    ], axis=-1)
            elif s.shape == "mesh":
                from .mesh import convex_hull_vertices, load_stl

                pts = convex_hull_vertices(
                    load_stl(self._resolve_mesh_path(s.filename)))
                pts = pts * np.asarray(s.size)  # per-axis URDF scale
            else:  # pragma: no cover — parser only emits the four above
                raise ValueError(f"unsupported collision shape {s.shape!r}")
            x, y, z, w = _rpy_to_quat(*s.origin_rpy)
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            out.append(pts @ R.T + np.asarray(s.origin_xyz))
            radii.append(np.full(len(pts), rad))
        return np.concatenate(out, axis=0), np.concatenate(radii, axis=0)

    def ancestors(self, link_idx: int) -> List[int]:
        """Root→link chain of link indices (inclusive)."""
        chain = []
        li = link_idx
        while li >= 0:
            chain.append(li)
            li = int(self.parent[li])
        return chain[::-1]

    def link_schedule(self, tip_link_indices: Sequence[int]) -> List[int]:
        """Deduped topologically-ordered links needed to pose the tips.

        Reference analog: RobotFK_Fast_Base link_schedule
        (forward_kinematics.h:268-282).
        """
        needed = set()
        for t in tip_link_indices:
            needed.update(self.ancestors(t))
        return sorted(needed)

    def actuated_variables(self, exclude_fixed_joints: Sequence[str] = ()) -> List[int]:
        """Variables of non-fixed, non-mimic joints, minus excluded joints.

        Reference analog: active-variable discovery, problem.cpp:186-204.
        """
        excluded = set(exclude_fixed_joints)
        out = []
        for li in range(1, self.nlinks):
            if self.jtype[li] == FIXED or self.joint_names[li] in excluded:
                continue
            if self.vstart[li] >= 0 and self.mimic_src[self.vstart[li]] < 0:
                out.extend(range(int(self.vstart[li]), int(self.vstart[li] + self.vcount[li])))
        return out

    def apply_mimic(self, q):
        """Propagate mimic sources: ``q[m] = q[src]·factor + offset``.

        Vectorized gather-scale-add (reference analog:
        forward_kinematics.h:230-246).  No-op when there are no mimic joints.
        """
        if not self.mimic_vars:
            return q
        dev = q.device
        src = torch.as_tensor(np.maximum(self.mimic_src, 0), device=dev)
        is_mimic = torch.as_tensor(self.mimic_src >= 0, device=dev)
        factor = torch.as_tensor(self.mimic_factor, dtype=q.dtype, device=dev)
        offset = torch.as_tensor(self.mimic_offset, dtype=q.dtype, device=dev)
        return torch.where(is_mimic, q[..., src] * factor + offset, q)

    def neutral_q(self, dtype=None) -> np.ndarray:
        """Mid-range configuration (host-side numpy)."""
        b = self._np_bounds
        q = 0.5 * (b["min"] + b["max"])
        # floating-joint quaternion w defaults to 1
        for li in range(self.nlinks):
            if self.jtype[li] == FLOATING:
                q[self.vstart[li] + 3 : self.vstart[li] + 6] = 0.0
                q[self.vstart[li] + 6] = 1.0
        return q.astype(dtype or self.dtype)
