"""Structured-parameter loading: dict / YAML → SolverConfig + goal lists.

Port of :mod:`bio_ik_tpu.params`, the counterpart of the reference's
parameter plumbing — the ``lookupParam`` ROS-param loads (reference:
src/kinematics_plugin.cpp:109-115, 243-267) and the ``XmlRpcReader``
structured deserializer for vectors and quaternions (reference:
src/utils.h:475-523, which accepts both array ``[x, y, z]`` and struct
``{x:, y:, z:}`` forms).  The configuration file
format mirrors what a MoveIt user would put in ``kinematics.yaml``
(reference: README.md:83-107) with an optional ``goals:`` list.

Example::

    mode: bio2_memetic
    dtwist: 1.0e-3
    rotation_scale: 0.5
    goals:
      - type: pose
        link: r_gripper_tool_frame
        weight: 1.0
      - type: avoid_joint_limits
        weight: 0.5
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from . import goals as G
from .config import SolverConfig

__all__ = [
    "config_from_dict",
    "goal_from_dict",
    "goals_from_dict",
    "goals_from_dicts",
    "load_yaml",
    "solver_from_spec",
    "GOAL_TYPES",
]

# snake_case type key → goal class (the reference keys goals by class;
# a string key is the data-driven equivalent)
GOAL_TYPES: Dict[str, type] = {
    "position": G.PositionGoal,
    "orientation": G.OrientationGoal,
    "pose": G.PoseGoal,
    "look_at": G.LookAtGoal,
    "lookat": G.LookAtGoal,  # alias (matches the reference's class name)
    "max_distance": G.MaxDistanceGoal,
    "min_distance": G.MinDistanceGoal,
    "line": G.LineGoal,
    "plane": G.PlaneGoal,
    "touch": G.TouchGoal,
    "avoid_joint_limits": G.AvoidJointLimitsGoal,
    "center_joints": G.CenterJointsGoal,
    "regularization": G.RegularizationGoal,
    "minimal_displacement": G.MinimalDisplacementGoal,
    "joint_variable": G.JointVariableGoal,
    "joint_function": G.JointFunctionGoal,
    "balance": G.BalanceGoal,
    "link_function": G.LinkFunctionGoal,
    "side": G.SideGoal,
    "direction": G.DirectionGoal,
    "cone": G.ConeGoal,
}

# reference ROS-param name → SolverConfig field (kinematics_plugin.cpp:252-267)
_CONFIG_ALIASES = {
    "threads": "islands",
    "random_seed": "seed",
}


def _vec(v: Any, n: int) -> Tuple[float, ...]:
    """Parse a length-``n`` vector from array or struct form
    (reference: utils.h:482-507 reads {x,y,z[,w]} structs or arrays)."""
    keys = ("x", "y", "z", "w")[:n]
    if isinstance(v, Mapping):
        return tuple(float(v[k]) for k in keys)
    out = tuple(float(x) for x in v)
    if len(out) != n:
        raise ValueError(f"expected {n} components, got {len(out)}: {v!r}")
    return out


def config_from_dict(d: Mapping[str, Any]) -> SolverConfig:
    """Build a :class:`SolverConfig` from a flat mapping.  Accepts this
    framework's field names plus the reference's ROS param names
    (``threads`` → islands, ``random_seed`` → seed); unknown keys raise
    (the reference silently keeps defaults — here misspellings fail
    loudly).  ``goals`` entries are ignored (see :func:`goals_from_dict`).
    """
    fields = {f.name: f.type for f in dataclasses.fields(SolverConfig)}
    kw: Dict[str, Any] = {}
    for k, v in d.items():
        if k == "goals":
            continue
        k = _CONFIG_ALIASES.get(k, k)
        if k not in fields:
            raise ValueError(
                f"unknown config key {k!r}; valid: {sorted(fields)}"
            )
        kw[k] = v
    return SolverConfig(**kw)


def goal_from_dict(d: Mapping[str, Any]) -> G.Goal:
    """Build one goal from ``{"type": ..., **params}``.  Vector-valued
    fields accept both array and ``{x,y,z[,w]}`` struct forms."""
    d = dict(d)
    tname = d.pop("type", None)
    if tname not in GOAL_TYPES:
        raise ValueError(
            f"unknown goal type {tname!r}; valid: {sorted(GOAL_TYPES)}"
        )
    cls = GOAL_TYPES[tname]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw: Dict[str, Any] = {}
    for k, v in d.items():
        if k not in fields:
            raise ValueError(
                f"{tname}: unknown field {k!r}; valid: {sorted(fields)}"
            )
        if k in ("position", "target", "axis", "direction", "normal"):
            v = _vec(v, 3)
        elif k == "orientation":
            v = _vec(v, 4)
        elif k == "points":
            v = tuple(_vec(p, 3) for p in v)
        elif k == "variable_names":
            v = tuple(str(s) for s in v)
        kw[k] = v
    return cls(**kw)


def goals_from_dict(items: Sequence[Mapping[str, Any]]) -> List[G.Goal]:
    return [goal_from_dict(d) for d in items]


goals_from_dicts = goals_from_dict  # alias


def solver_from_spec(model, spec: Mapping[str, Any]):
    """Build an :class:`bio_ik_tpu_torch.api.IKSolver` from one spec dict
    holding config fields + a ``goals`` list (+ optional ``fixed_joints``) —
    the data-driven analog of the reference plugin's full ROS-param surface
    (kinematics_plugin.cpp:243-335).  The solver runs on ``model``'s
    device."""
    from .api import IKSolver

    spec = dict(spec)
    goal_dicts = spec.pop("goals")
    fixed_joints = spec.pop("fixed_joints", ())
    cfg = config_from_dict(spec)
    return IKSolver(model, goals_from_dict(goal_dicts), cfg,
                    fixed_joints=fixed_joints)


def load_yaml(path: str) -> Tuple[SolverConfig, List[G.Goal]]:
    """Load ``(config, goals)`` from a YAML file (kinematics.yaml analog).

    Requires PyYAML, imported here only: nothing else of the package needs
    it."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return config_from_dict(d), goals_from_dict(d.get("goals", ()))
