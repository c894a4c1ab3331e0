"""User-facing goal types — the public objective API.

TPU-native counterpart of the reference's ~20 concrete goal classes
(reference: include/bio_ik/goal_types.h:80-713).  Goals here are plain
frozen dataclasses; :mod:`bio_ik_tpu_torch.problem` compiles a goal list into
struct-of-arrays batches evaluated by vectorized kernels — goals are data,
not virtual dispatch.

Fitness contract (reference: problem.cpp:244-257): each goal type defines a
**squared** error ``e``; the total fitness is ``Σ weight²·e``.  Goals with
``secondary=True`` are excluded from the primary fitness and evaluated
separately on joint variables only (pre-selection + tie-breaking,
reference: ik_evolution_2.cpp:366-378, ik_parallel.h:229-240); secondary
goals therefore must not reference tip frames.

All direction/axis/normal/orientation parameters are normalized at problem
compile time (the reference normalizes in setters and constructors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

__all__ = [
    "Goal",
    "PositionGoal",
    "OrientationGoal",
    "PoseGoal",
    "LookAtGoal",
    "MaxDistanceGoal",
    "MinDistanceGoal",
    "LineGoal",
    "PlaneGoal",
    "TouchGoal",
    "AvoidJointLimitsGoal",
    "CenterJointsGoal",
    "RegularizationGoal",
    "MinimalDisplacementGoal",
    "JointVariableGoal",
    "JointFunctionGoal",
    "BalanceGoal",
    "LinkFunctionGoal",
    "SideGoal",
    "DirectionGoal",
    "ConeGoal",
]

Vec3 = Tuple[float, float, float]
Quat = Tuple[float, float, float, float]  # xyzw


@dataclass(frozen=True)
class Goal:
    """Base: common weight/secondary flags (reference: goal.h:97-119)."""

    weight: float = 1.0
    secondary: bool = False


# --------------------------------------------------------------------------
# link-frame goals
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PositionGoal(Goal):
    """``‖p_link − p_goal‖²`` (reference: goal_types.h:80-97)."""

    link: str = ""
    position: Vec3 = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class OrientationGoal(Goal):
    """``min(‖q−q̂‖², ‖q+q̂‖²)`` — double-cover-safe
    (reference: goal_types.h:99-124)."""

    link: str = ""
    orientation: Quat = (0.0, 0.0, 0.0, 1.0)


@dataclass(frozen=True)
class PoseGoal(Goal):
    """``‖Δp‖² + rotation_scale²·min(‖q−q̂‖², ‖q+q̂‖²)``
    (reference: goal_types.h:126-181; default rotation_scale 0.5)."""

    link: str = ""
    position: Vec3 = (0.0, 0.0, 0.0)
    orientation: Quat = (0.0, 0.0, 0.0, 1.0)
    rotation_scale: float = 0.5


@dataclass(frozen=True)
class LookAtGoal(Goal):
    """``‖normalize(target−p) − normalize(R·axis)‖²``
    (reference: goal_types.h:183-211)."""

    link: str = ""
    axis: Vec3 = (1.0, 0.0, 0.0)
    target: Vec3 = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class MaxDistanceGoal(Goal):
    """``max(0, ‖p−t‖−d)²`` (reference: goal_types.h:214-241)."""

    link: str = ""
    target: Vec3 = (0.0, 0.0, 0.0)
    distance: float = 1.0


@dataclass(frozen=True)
class MinDistanceGoal(Goal):
    """``max(0, d−‖p−t‖)²`` (reference: goal_types.h:243-270)."""

    link: str = ""
    target: Vec3 = (0.0, 0.0, 0.0)
    distance: float = 1.0


@dataclass(frozen=True)
class LineGoal(Goal):
    """Squared distance of the link position to a line
    (reference: goal_types.h:272-298)."""

    link: str = ""
    position: Vec3 = (0.0, 0.0, 0.0)
    direction: Vec3 = (0.0, 0.0, 1.0)


@dataclass(frozen=True)
class PlaneGoal(Goal):
    """Signed plane distance, squared (reference: goal_types.h:300-328)."""

    link: str = ""
    position: Vec3 = (0.0, 0.0, 0.0)
    normal: Vec3 = (0.0, 0.0, 1.0)


@dataclass(frozen=True)
class TouchGoal(Goal):
    """Signed distance of the link's collision surface to a plane, squared
    (reference: goal_types.h:330-377, goal_types.cpp:45-228 — there a
    convex-mesh support function over FCL geometry; here the surface is a
    convex point cloud in link coordinates and the support point is an
    exact max over points — the dense-batch analog of the reference's
    edge-walk hill climb).

    ``points`` empty (the default) derives the cloud from the link's URDF
    collision geometry (``RobotModel.collision_support``), matching the
    reference's automatic collision-geometry derivation; a non-empty
    tuple supplies the surface explicitly (e.g. for mesh links)."""

    link: str = ""
    position: Vec3 = (0.0, 0.0, 0.0)
    normal: Vec3 = (0.0, 0.0, 1.0)
    points: Tuple[Vec3, ...] = ()  # link-local surface; () ⇒ from URDF


@dataclass(frozen=True)
class SideGoal(Goal):
    """``max(0, (R·axis)·dir)²`` (reference: goal_types.h:585-614)."""

    link: str = ""
    axis: Vec3 = (0.0, 0.0, 1.0)
    direction: Vec3 = (0.0, 0.0, 1.0)


@dataclass(frozen=True)
class DirectionGoal(Goal):
    """``‖R·axis − dir‖²`` (reference: goal_types.h:616-644)."""

    link: str = ""
    axis: Vec3 = (0.0, 0.0, 1.0)
    direction: Vec3 = (0.0, 0.0, 1.0)


@dataclass(frozen=True)
class ConeGoal(Goal):
    """``max(0, angle(R·axis, dir) − angle)² + position_weight²·‖Δp‖²``
    (reference: goal_types.h:646-712)."""

    link: str = ""
    axis: Vec3 = (0.0, 0.0, 1.0)
    direction: Vec3 = (0.0, 0.0, 1.0)
    angle: float = 0.0
    position: Vec3 = (0.0, 0.0, 0.0)
    position_weight: float = 0.0


@dataclass(frozen=True)
class LinkFunctionGoal(Goal):
    """User function ``f(pos (3,), quat (4,)) → squared error``, must be
    written in torch ops (reference: goal_types.h:570-583).  The solvers
    that replay CUDA graphs run it inside one, so on the card it must not
    copy from the host: build its constant tensors once, outside it."""

    link: str = ""
    function: Optional[Callable] = None


# --------------------------------------------------------------------------
# joint-space goals (valid as secondary)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AvoidJointLimitsGoal(Goal):
    """``Σ [max(0, 2·|q−mid| − span/2)·w_i]²`` over bounded variables
    (reference: goal_types.h:379-402).  Secondary by default."""

    secondary: bool = True


@dataclass(frozen=True)
class CenterJointsGoal(Goal):
    """``Σ [(q−mid)·w_i]²`` over bounded variables
    (reference: goal_types.h:404-426).  Secondary by default."""

    secondary: bool = True


@dataclass(frozen=True)
class RegularizationGoal(Goal):
    """``Σ (q−q_seed)²`` unweighted (reference: goal_types.h:428-445)."""


@dataclass(frozen=True)
class MinimalDisplacementGoal(Goal):
    """``Σ [(q−q_seed)·w_i]²`` with velocity-normalized factors
    (reference: goal_types.h:447-466, problem.cpp:206-225).
    Secondary by default."""

    secondary: bool = True


@dataclass(frozen=True)
class JointVariableGoal(Goal):
    """``(q_var − target)²`` for one named variable
    (reference: goal_types.h:468-499)."""

    variable_name: str = ""
    variable_position: float = 0.0


@dataclass(frozen=True)
class JointFunctionGoal(Goal):
    """User function mapping selected variable values to preferred values:
    ``Σ (f(q)−q)²``; ``function`` must be written in torch ops ``(k,) → (k,)``
    (reference: goal_types.h:501-538, where f mutates the vector in place).
    On the card it must not copy from the host, as ``LinkFunctionGoal``'s.
    """

    variable_names: Tuple[str, ...] = ()
    function: Optional[Callable] = None


@dataclass(frozen=True)
class BalanceGoal(Goal):
    """Mass-weighted center of mass (URDF inertials), projected onto the
    plane ⊥ ``axis``, vs ``target``: ``‖·‖²``
    (reference: goal_types.h:540-568, goal_types.cpp:231-272)."""

    target: Vec3 = (0.0, 0.0, 0.0)
    axis: Vec3 = (0.0, 0.0, 1.0)
