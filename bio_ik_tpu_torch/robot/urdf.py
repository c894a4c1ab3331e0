"""Minimal, ROS-free URDF parser.

The reference obtains its robot model from MoveIt (urdf+srdf via the ROS
parameter server, kinematics_plugin.cpp:167-189).  This framework instead
parses URDF XML directly into plain dataclasses, which
:mod:`bio_ik_tpu_torch.robot.model` then compiles into host arrays and
torch tensors.

Parsed subset: links (name + inertial for center-of-mass goals +
collision primitives for TouchGoal surface derivation), joints (type,
parent/child, origin, axis, limits, mimic).  Visual elements and mesh
file references are ignored (mesh collision shapes would need the mesh
asset; the reference loads them through MoveIt/FCL,
goal_types.cpp:45-228 — here primitive collision geometry is compiled
to convex support point clouds, see RobotModel.collision_points).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["UrdfCollision", "UrdfJoint", "UrdfLink", "UrdfRobot",
           "parse_urdf", "load_urdf"]

# Joint type ids shared with the compiled model. FIXED must be 0 (default).
FIXED, REVOLUTE, PRISMATIC, FLOATING, PLANAR = 0, 1, 2, 3, 4

_TYPE_MAP = {
    "fixed": FIXED,
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "floating": FLOATING,
    "planar": PLANAR,
}


@dataclass
class UrdfJoint:
    name: str
    type: int                      # one of the ids above
    parent: str                    # parent link name
    child: str                     # child link name
    origin_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    lower: float = 0.0
    upper: float = 0.0
    velocity: float = 0.0
    continuous: bool = False       # "continuous" joint: unbounded revolute
    mimic_joint: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclass
class UrdfCollision:
    """One collision shape of a link, in link coordinates.

    ``shape`` ∈ {"box", "cylinder", "sphere", "mesh"}; ``size`` holds
    (sx,sy,sz) for boxes, (radius, length) for cylinders, (radius,) for
    spheres, and the (sx,sy,sz) scale factors for meshes (``filename``
    then references the mesh file).
    """

    shape: str
    size: Tuple[float, ...]
    origin_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    filename: Optional[str] = None


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # inertial origin xyz
    collisions: List["UrdfCollision"] = field(default_factory=list)


@dataclass
class UrdfRobot:
    name: str
    links: Dict[str, UrdfLink] = field(default_factory=dict)
    joints: List[UrdfJoint] = field(default_factory=list)

    @property
    def root_link(self) -> str:
        children = {j.child for j in self.joints}
        roots = [name for name in self.links if name not in children]
        if len(roots) != 1:
            raise ValueError(f"URDF must have exactly one root link, got {roots}")
        return roots[0]


def _floats(s: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in s.split())


def parse_urdf(xml_text: str) -> UrdfRobot:
    root = ET.fromstring(xml_text)
    if root.tag != "robot":
        raise ValueError(f"expected <robot> root element, got <{root.tag}>")
    robot = UrdfRobot(name=root.get("name", "robot"))

    for link_el in root.findall("link"):
        name = link_el.get("name")
        mass, com = 0.0, (0.0, 0.0, 0.0)
        inertial = link_el.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            if mass_el is not None:
                mass = float(mass_el.get("value", "0"))
            origin_el = inertial.find("origin")
            if origin_el is not None and origin_el.get("xyz"):
                com = _floats(origin_el.get("xyz"))
        collisions = []
        for col_el in link_el.findall("collision"):
            geom_el = col_el.find("geometry")
            if geom_el is None:
                continue
            shape = None
            if (box := geom_el.find("box")) is not None and box.get("size"):
                shape = UrdfCollision("box", _floats(box.get("size")))
            elif (cyl := geom_el.find("cylinder")) is not None:
                shape = UrdfCollision(
                    "cylinder",
                    (float(cyl.get("radius", "0")),
                     float(cyl.get("length", "0"))),
                )
            elif (sph := geom_el.find("sphere")) is not None:
                shape = UrdfCollision("sphere",
                                      (float(sph.get("radius", "0")),))
            elif (msh := geom_el.find("mesh")) is not None and msh.get(
                    "filename"):
                scale = (_floats(msh.get("scale"))
                         if msh.get("scale") else (1.0, 1.0, 1.0))
                shape = UrdfCollision("mesh", scale,
                                      filename=msh.get("filename"))
            if shape is None:
                continue  # unknown geometry: skip
            origin_el = col_el.find("origin")
            if origin_el is not None:
                if origin_el.get("xyz"):
                    shape.origin_xyz = _floats(origin_el.get("xyz"))
                if origin_el.get("rpy"):
                    shape.origin_rpy = _floats(origin_el.get("rpy"))
            collisions.append(shape)
        robot.links[name] = UrdfLink(name=name, mass=mass, com=com,
                                     collisions=collisions)

    for joint_el in root.findall("joint"):
        jtype_str = joint_el.get("type")
        if jtype_str not in _TYPE_MAP:
            raise ValueError(f"unsupported joint type {jtype_str!r}")
        joint = UrdfJoint(
            name=joint_el.get("name"),
            type=_TYPE_MAP[jtype_str],
            parent=joint_el.find("parent").get("link"),
            child=joint_el.find("child").get("link"),
            continuous=(jtype_str == "continuous"),
        )
        origin_el = joint_el.find("origin")
        if origin_el is not None:
            if origin_el.get("xyz"):
                joint.origin_xyz = _floats(origin_el.get("xyz"))
            if origin_el.get("rpy"):
                joint.origin_rpy = _floats(origin_el.get("rpy"))
        axis_el = joint_el.find("axis")
        if axis_el is not None and axis_el.get("xyz"):
            ax = _floats(axis_el.get("xyz"))
            n = math.sqrt(sum(a * a for a in ax))
            if n == 0:
                raise ValueError(f"joint {joint.name}: zero axis")
            joint.axis = tuple(a / n for a in ax)
        limit_el = joint_el.find("limit")
        if limit_el is not None:
            joint.lower = float(limit_el.get("lower", "0"))
            joint.upper = float(limit_el.get("upper", "0"))
            joint.velocity = float(limit_el.get("velocity", "0"))
        if joint.continuous:
            # MoveIt convention: continuous joints report [-π, π] bounds but
            # are treated as position-unbounded (robot_info.h:82-90).
            joint.lower, joint.upper = -math.pi, math.pi
        mimic_el = joint_el.find("mimic")
        if mimic_el is not None:
            joint.mimic_joint = mimic_el.get("joint")
            joint.mimic_multiplier = float(mimic_el.get("multiplier", "1"))
            joint.mimic_offset = float(mimic_el.get("offset", "0"))
        if joint.parent not in robot.links:
            raise ValueError(f"joint {joint.name}: unknown parent link {joint.parent}")
        if joint.child not in robot.links:
            raise ValueError(f"joint {joint.name}: unknown child link {joint.child}")
        robot.joints.append(joint)

    return robot


def load_urdf(path: str) -> UrdfRobot:
    with open(path) as f:
        return parse_urdf(f.read())
