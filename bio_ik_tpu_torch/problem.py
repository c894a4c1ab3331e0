"""Problem compilation and fitness evaluation.

Port of :mod:`bio_ik_tpu.problem` (reference: src/problem.h:118-136,
src/problem.cpp:72-341): a goal list compiles into a
deduped tip list, the active-variable set, per-kind struct-of-arrays goal
groups whose numeric parameters live in the ``data`` dict from
:meth:`Problem.make_data`, and the vectorized acceptance test.

It carries every goal kind of the JAX package: the pose family (position,
orientation, pose), the eight other kinds the fused step evaluates
in-kernel (lookat, max_distance, min_distance, line, plane, side,
direction, cone), the five joint-space kinds (avoid_joint_limits,
center_joints, regularization, minimal_displacement, joint_variable, also
as secondary goals), and the four only the island path evaluates: touch,
balance, link_function and joint_function (the last also as a secondary
goal).  A function goal's callable takes torch tensors and must be
differentiable by autograd (the memetic gradient runs through it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import goals as G
from .config import DEFAULT_CONFIG, SolverConfig
from .math.frame import Frame
from .math.quat import (
    cross,
    quat_angle_atan2,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_rotvec_wrapped,
)
from .robot.model import RobotModel

__all__ = ["Problem", "GoalGroup"]

_JOINT_KINDS = ("avoid_joint_limits", "center_joints", "regularization",
                "minimal_displacement", "joint_variable")
# the kinds the fused step evaluates besides the pose family
# (kernels/bio2_fullstep.eval_goals)
_LINK_KINDS = ("lookat", "max_distance", "min_distance", "line", "plane",
               "side", "direction", "cone")
# the kinds valid as secondary goals (JAX problem.py:154-168)
_SECONDARY_KINDS = _JOINT_KINDS + ("joint_function",)


def _norm(v):
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@dataclass
class GoalGroup:
    """One vectorized batch of same-kind goals."""

    kind: str
    tip_slots: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    static: Dict[str, Any] = field(default_factory=dict)
    params: Dict[str, np.ndarray] = field(default_factory=dict)
    weight_sq: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # acceptance classification (reference: problem.cpp:153-176)
    goal_type: str = "unknown"
    # index tensors built from the static arrays, per device (a host copy
    # per evaluation would synchronize the card each time)
    _on_device: Dict[Any, torch.Tensor] = field(default_factory=dict, repr=False,
                                                compare=False)

    def index(self, name: str, device) -> torch.Tensor:
        """``tip_slots`` or the static array ``name`` as a tensor on
        ``device``, built once."""
        key = (name, torch.device(device))
        if key not in self._on_device:
            arr = self.tip_slots if name == "tip_slots" else self.static[name]
            self._on_device[key] = torch.as_tensor(arr, device=device)
        return self._on_device[key]

    @property
    def count(self) -> int:
        return len(self.weight_sq)


class Problem:
    """A compiled IK problem for one robot + goal structure."""

    def __init__(
        self,
        model: RobotModel,
        goal_list: Sequence[G.Goal],
        fixed_joints: Sequence[str] = (),
        active_variables: Optional[Sequence[int]] = None,
        config: SolverConfig = DEFAULT_CONFIG,
    ):
        self.model = model
        self.config = config
        self.device = model.device
        self.goal_list = list(goal_list)
        self.dtype = np.dtype(config.dtype)
        self.tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype

        # the tip links, deduplicated in order of first use: the goals'
        # links, then those a builder adds (balance: every massive link)
        self.tip_links: List[str] = []

        for g in self.goal_list:
            if g.secondary and _KIND_OF[type(g)] not in _SECONDARY_KINDS:
                raise ValueError(
                    f"secondary goals must be joint-space goals, got {type(g).__name__}")

        if active_variables is None:
            active = list(model.actuated_variables(exclude_fixed_joints=fixed_joints))
        else:
            active = list(active_variables)
        # variables named by goals join the active set unless their joint is
        # fixed (reference: problem.cpp:102-204)
        fixed = set(fixed_joints)
        for g in self.goal_list:
            names: Tuple[str, ...] = ()
            if isinstance(g, G.JointVariableGoal):
                names = (g.variable_name,)
            elif isinstance(g, G.JointFunctionGoal):
                names = tuple(g.variable_names)
            for n in names:
                if n not in model.var_index:
                    raise ValueError(f"unknown variable {n!r}")
                v = model.var_index[n]
                joint_of_v = None
                for li, vs in enumerate(model.vstart):
                    if vs >= 0 and vs <= v < vs + model.vcount[li]:
                        joint_of_v = model.joint_names[li]
                if v not in active and joint_of_v not in fixed:
                    active.append(v)
        self.active_vars = active
        V = len(active)
        av = np.asarray(active, dtype=np.int64)

        b = model._np_bounds

        def dev(x):
            return torch.as_tensor(np.asarray(x).astype(self.dtype),
                                   device=self.device)

        self.amin = dev(b["min"][av])
        self.amax = dev(b["max"][av])
        self.aclip_min = dev(b["clip_min"][av])
        self.aclip_max = dev(b["clip_max"][av])
        self.aspan = dev(b["span"][av])
        self.amid = dev(0.5 * (b["min"][av] + b["max"][av]))
        self.abounded = dev(np.isfinite(b["clip_max"][av]))
        # velocity-normalized displacement factors (reference:
        # problem.cpp:206-225)
        rcp = b["max_velocity_rcp"][av]
        s = rcp.sum()
        self.velocity_weights = dev(
            rcp / s if s > 0 else np.full(V, 1.0 / max(V, 1)))

        self.primary: List[GoalGroup] = []
        self.secondary: List[GoalGroup] = []
        pending: Dict[Tuple[str, bool], List[Tuple[G.Goal, int]]] = {}
        for g in self.goal_list:
            kind = _KIND_OF[type(g)]
            slot = self.tip_slot(g.link) if getattr(g, "link", "") else -1
            pending.setdefault((kind, g.secondary), []).append((g, slot))

        for (kind, secondary), items in pending.items():
            # a builder gives its groups: one, or one per goal (the function
            # goals and balance, whose static structure differs per goal)
            for grp in _BUILDERS[kind](self, items):
                grp.kind = kind
                grp.goal_type = kind if kind in _POSE_TYPES else "unknown"
                (self.secondary if secondary else self.primary).append(grp)

        self.ntips = len(self.tip_links)
        self.dpos = config.dpos
        self.drot = config.drot
        self.dtwist = config.dtwist

    def tip_slot(self, link: str) -> int:
        """The slot of ``link`` among the tips, added at the end when new."""
        if link not in self.model.link_index:
            raise ValueError(f"unknown link {link!r}")
        if link not in self.tip_links:
            self.tip_links.append(link)
        return self.tip_links.index(link)

    # ------------------------------------------------------------------
    def make_data(self, q_seed_full) -> Dict[str, Any]:
        """Numeric data dict for one solve (reference: problem.initial_guess,
        kinematics_plugin.cpp:506-507); callers may replace entries or stack
        a leading scenario-batch axis on every leaf."""
        q = torch.as_tensor(q_seed_full, device=self.device).to(self.tdtype)
        av = torch.as_tensor(self.active_vars, dtype=torch.long, device=self.device)

        def group_data(grp):
            d = {k: torch.as_tensor(v.astype(self.dtype), device=self.device)
                 for k, v in grp.params.items()}
            d["weight_sq"] = torch.as_tensor(grp.weight_sq.astype(self.dtype),
                                             device=self.device)
            return d

        return {
            "seed_full": q,
            "seed_active": q[..., av],
            "primary": [group_data(g) for g in self.primary],
            "secondary": [group_data(g) for g in self.secondary],
        }

    # ------------------------------------------------------------------
    def fitness(self, tips, qa, data):
        """Primary fitness ``Σ weight²·e`` (reference: problem.cpp:251-257);
        ``tips (..., T, 7)`` packed, ``qa (..., V)``."""
        total = torch.zeros(qa.shape[:-1], dtype=self.tdtype, device=qa.device)
        for grp, gdata in zip(self.primary, data["primary"]):
            e = _EVALUATORS[grp.kind](self, grp, gdata, tips, qa, data)
            total = total + torch.sum(gdata["weight_sq"] * e, dim=-1)
        return total

    def fitness_secondary(self, qa, data):
        """Secondary fitness on joint variables only (reference:
        ik_base.h:163-185, evaluated against null tip frames)."""
        total = torch.zeros(qa.shape[:-1], dtype=self.tdtype, device=qa.device)
        for grp, gdata in zip(self.secondary, data["secondary"]):
            e = _EVALUATORS[grp.kind](self, grp, gdata, None, qa, data)
            total = total + torch.sum(gdata["weight_sq"] * e, dim=-1)
        return total

    def fitness_combined(self, tips, qa, data):
        return self.fitness(tips, qa, data) + self.fitness_secondary(qa, data)

    @property
    def has_secondary(self) -> bool:
        return bool(self.secondary)

    # ------------------------------------------------------------------
    def check_solution(self, tips_frame: Frame, qa, data):
        """Vectorized tolerance acceptance test (reference:
        checkSolutionActiveVariables, problem.cpp:259-341).  ``tips_frame``
        must come from exact FK."""
        dpos, drot, dtwist = self.dpos, self.drot, self.dtwist
        ok = torch.ones(tips_frame.pos.shape[:-2], dtype=torch.bool,
                        device=tips_frame.pos.device)
        tips = None
        for grp, gdata in zip(self.primary, data["primary"]):
            if grp.goal_type == "unknown":
                # joint-space primaries: weighted error below the tighter of
                # the two tolerances (reference: problem.cpp:323-338)
                dmax = min(dpos, dtwist)
                if math.isfinite(dmax):
                    if tips is None:
                        tips = torch.cat([tips_frame.pos, tips_frame.quat], -1)
                    e = _EVALUATORS[grp.kind](self, grp, gdata, tips, qa, data)
                    ok &= torch.all(gdata["weight_sq"] * e < dmax * dmax, dim=-1)
                continue
            slots = grp.index("tip_slots", ok.device)
            tp = tips_frame.pos[..., slots, :]
            tq = tips_frame.quat[..., slots, :]
            if grp.goal_type in ("position", "pose") and math.isfinite(dpos):
                dp = tp - gdata["position"]
                ok &= torch.all(torch.linalg.vector_norm(dp, dim=-1) <= dpos,
                                dim=-1)
            if grp.goal_type in ("orientation", "pose") and math.isfinite(drot):
                # 2·atan2(‖v‖, |w|) of tip⁻¹·goal: the JAX package's clamped
                # arccos of the dot (math/quat.py:162) reads 0 below ~1 mrad
                # once FK's rounding leaves the norms' product above 1, as
                # on the card; both read the same angle in float64
                ang = quat_angle_atan2(tq, gdata["orientation"]) * (
                    180.0 / math.pi)
                ok &= torch.all(ang <= drot, dim=-1)
            if math.isfinite(dtwist):
                # twist of goal⁻¹·tip in goal coordinates, component-wise
                # |·| ≤ dtwist (KDL::Equal semantics; reference
                # problem.cpp:276-322, frame.h:240-259)
                gq = gdata.get("orientation")
                gp = gdata.get("position")
                if gq is None:
                    comps = [tp - gp]
                else:
                    gq_inv = quat_conj(gq)
                    rot = quat_to_rotvec_wrapped(quat_mul(gq_inv, tq))
                    if grp.goal_type == "pose":
                        comps = [quat_rotate(gq_inv, tp - gp), rot]
                    else:
                        comps = [rot]
                for c in comps:
                    ok &= torch.all(torch.abs(c) <= dtwist, dim=-1).all(dim=-1)
        return ok


# ==========================================================================
# goal kind registry
# ==========================================================================

_KIND_OF = {
    G.PositionGoal: "position",
    G.OrientationGoal: "orientation",
    G.PoseGoal: "pose",
    G.LookAtGoal: "lookat",
    G.MaxDistanceGoal: "max_distance",
    G.MinDistanceGoal: "min_distance",
    G.LineGoal: "line",
    G.PlaneGoal: "plane",
    G.TouchGoal: "touch",
    G.SideGoal: "side",
    G.DirectionGoal: "direction",
    G.ConeGoal: "cone",
    G.LinkFunctionGoal: "link_function",
    G.AvoidJointLimitsGoal: "avoid_joint_limits",
    G.CenterJointsGoal: "center_joints",
    G.RegularizationGoal: "regularization",
    G.MinimalDisplacementGoal: "minimal_displacement",
    G.JointVariableGoal: "joint_variable",
    G.JointFunctionGoal: "joint_function",
    G.BalanceGoal: "balance",
}


_POSE_TYPES = ("position", "orientation", "pose")


def _simple_group(items, **param_fns) -> GoalGroup:
    grp = GoalGroup(kind="")
    grp.tip_slots = np.asarray([slot for _, slot in items], dtype=np.int64)
    grp.weight_sq = np.asarray([g.weight**2 for g, _ in items])
    for name, fn in param_fns.items():
        grp.params[name] = np.stack([np.asarray(fn(g), np.float64) for g, _ in items])
    return grp


def _single_group(items) -> GoalGroup:
    grp = GoalGroup(kind="")
    grp.weight_sq = np.asarray([g.weight**2 for g, _ in items])
    return grp


def _var_gather(problem, grp, names):
    """The arrays :func:`_gather_goal_vars` reads for variables ``names``:
    each one's active slot (−1 when it is not active) and full-vector
    index; the gather index (0 where inactive) and the mask."""
    vidx = [problem.model.var_index[n] for n in names]
    act = problem.active_vars
    grp.static["slots"] = np.asarray([act.index(v) if v in act else -1 for v in vidx],
                                     np.int64)
    grp.static["vidx"] = np.asarray(vidx, np.int64)
    grp.static["slot"] = np.maximum(grp.static["slots"], 0)
    grp.static["active"] = grp.static["slots"] >= 0


def _build_jv(problem, items):
    """joint_variable: each goal's active slot (−1 when its variable is not
    active) and full-vector index, and its target as a data parameter."""
    grp = _single_group(items)
    _var_gather(problem, grp, [g.variable_name for g, _ in items])
    grp.params["target"] = np.asarray([g.variable_position for g, _ in items])
    return [grp]


def _build_touch(problem, items):
    """touch: each goal's surface — its explicit points (radius 0), or the
    support set of its link's URDF collision geometry
    (``RobotModel.collision_support``: a sphere enters as its center with
    its radius) — padded to a common length by repeating the last point
    (JAX problem.py:502-530)."""
    grp = _simple_group(items, position=lambda g: g.position,
                        normal=lambda g: _norm(g.normal))
    clouds = [(np.asarray(g.points, np.float64), np.zeros(len(g.points)))
              if g.points else problem.model.collision_support(g.link)
              for g, _ in items]
    maxp = max(len(c) for c, _ in clouds)
    pts = np.zeros((len(items), maxp, 3))
    rad = np.zeros((len(items), maxp))
    for i, (p, r) in enumerate(clouds):
        pts[i, :len(p)], pts[i, len(p):] = p, p[-1]
        rad[i, :len(p)], rad[i, len(p):] = r, r[-1]
    grp.params["points"] = pts
    grp.params["radii"] = rad
    return [grp]


def _build_link_function(problem, items):
    """link_function: one group per goal, its callable static (JAX
    problem.py:598-606)."""
    groups = []
    for g, slot in items:
        grp = _simple_group([(g, slot)])
        grp.static["function"] = g.function
        groups.append(grp)
    return groups


def _build_jf(problem, items):
    """joint_function: one group per goal, its variables' gather arrays and
    its callable static (JAX problem.py:705-719)."""
    groups = []
    for g, _ in items:
        grp = _single_group([(g, -1)])
        _var_gather(problem, grp, g.variable_names)
        grp.static["function"] = g.function
        groups.append(grp)
    return groups


def _build_balance(problem, items):
    """balance: every link with inertial mass becomes a tip (reference:
    BalanceGoal::describe, goal_types.cpp:231-255); its mass fraction and
    center of mass in link coordinates are static, the target and the axis
    data (JAX problem.py:730-755)."""
    m = problem.model
    massive = [li for li in range(m.nlinks) if m.masses[li] > 0]
    if not massive and items:
        raise ValueError("BalanceGoal requires links with inertial mass in the URDF")
    total = sum(m.masses[li] for li in massive)
    groups = []
    for g, _ in items:
        grp = _single_group([(g, -1)])
        grp.tip_slots = np.asarray([problem.tip_slot(m.link_names[li])
                                    for li in massive], np.int64)
        grp.static["mass_frac"] = np.asarray([m.masses[li] / total for li in massive])
        grp.static["coms"] = np.asarray([m.coms[li] for li in massive])
        grp.params["target"] = np.asarray(g.target, np.float64)[None]
        grp.params["axis"] = _norm(g.axis)[None]
        groups.append(grp)
    return groups


def _listed(build):
    """A one-group builder as a builder of a list of groups."""
    return lambda p, items: [build(p, items)]


# the kinds whose goals share one group
_ONE_GROUP = {
    "position": lambda p, items: _simple_group(items, position=lambda g: g.position),
    "orientation": lambda p, items: _simple_group(
        items, orientation=lambda g: _norm(g.orientation)),
    "pose": lambda p, items: _simple_group(
        items,
        position=lambda g: g.position,
        orientation=lambda g: _norm(g.orientation),
        rotation_scale_sq=lambda g: g.rotation_scale**2,
    ),
    "lookat": lambda p, items: _simple_group(
        items, axis=lambda g: _norm(g.axis), target=lambda g: g.target),
    "max_distance": lambda p, items: _simple_group(
        items, target=lambda g: g.target, distance=lambda g: g.distance),
    "min_distance": lambda p, items: _simple_group(
        items, target=lambda g: g.target, distance=lambda g: g.distance),
    "line": lambda p, items: _simple_group(
        items, position=lambda g: g.position, direction=lambda g: _norm(g.direction)),
    "plane": lambda p, items: _simple_group(
        items, position=lambda g: g.position, normal=lambda g: _norm(g.normal)),
    "side": lambda p, items: _simple_group(
        items, axis=lambda g: _norm(g.axis), direction=lambda g: _norm(g.direction)),
    "direction": lambda p, items: _simple_group(
        items, axis=lambda g: _norm(g.axis), direction=lambda g: _norm(g.direction)),
    "cone": lambda p, items: _simple_group(
        items,
        axis=lambda g: _norm(g.axis),
        direction=lambda g: _norm(g.direction),
        angle=lambda g: g.angle,
        position=lambda g: g.position,
        position_weight_sq=lambda g: g.position_weight**2,
    ),
    "avoid_joint_limits": lambda p, items: _single_group(items),
    "center_joints": lambda p, items: _single_group(items),
    "regularization": lambda p, items: _single_group(items),
    "minimal_displacement": lambda p, items: _single_group(items),
}

_BUILDERS = {
    **{kind: _listed(build) for kind, build in _ONE_GROUP.items()},
    "joint_variable": _build_jv,
    "touch": _build_touch,
    "link_function": _build_link_function,
    "joint_function": _build_jf,
    "balance": _build_balance,
}


def _tip_pq(tips, grp):
    slots = grp.index("tip_slots", tips.device)
    return tips[..., slots, 0:3], tips[..., slots, 3:7]


def _quat_err_sq(tq, gq):
    dm = torch.sum(torch.square(tq - gq), dim=-1)
    dp = torch.sum(torch.square(tq + gq), dim=-1)
    return torch.minimum(dm, dp)


def _eval_position(problem, grp, gdata, tips, qa, data):
    tp, _ = _tip_pq(tips, grp)
    return torch.sum(torch.square(tp - gdata["position"]), dim=-1)


def _eval_orientation(problem, grp, gdata, tips, qa, data):
    _, tq = _tip_pq(tips, grp)
    return _quat_err_sq(tq, gdata["orientation"])


def _eval_pose(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    ep = torch.sum(torch.square(tp - gdata["position"]), dim=-1)
    er = _quat_err_sq(tq, gdata["orientation"])
    return ep + gdata["rotation_scale_sq"] * er


# ---- directional and distance link goals (JAX problem.py:431-609) -------


def _normalize_rows(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _eval_lookat(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    v = _normalize_rows(quat_rotate(tq, gdata["axis"]))
    n = _normalize_rows(gdata["target"] - tp)
    return torch.sum(torch.square(n - v), dim=-1)


def _eval_maxd(problem, grp, gdata, tips, qa, data):
    tp, _ = _tip_pq(tips, grp)
    d = torch.linalg.vector_norm(tp - gdata["target"], dim=-1) - gdata["distance"]
    d = torch.clamp(d, min=0.0)
    return d * d


def _eval_mind(problem, grp, gdata, tips, qa, data):
    tp, _ = _tip_pq(tips, grp)
    d = gdata["distance"] - torch.linalg.vector_norm(tp - gdata["target"], dim=-1)
    d = torch.clamp(d, min=0.0)
    return d * d


def _eval_line(problem, grp, gdata, tips, qa, data):
    tp, _ = _tip_pq(tips, grp)
    d = tp - gdata["position"]
    along = torch.sum(d * gdata["direction"], dim=-1, keepdim=True)
    perp = d - gdata["direction"] * along
    return torch.sum(torch.square(perp), dim=-1)


def _eval_plane(problem, grp, gdata, tips, qa, data):
    tp, _ = _tip_pq(tips, grp)
    sd = torch.sum((tp - gdata["position"]) * gdata["normal"], dim=-1)
    return sd * sd


def _eval_side(problem, grp, gdata, tips, qa, data):
    _, tq = _tip_pq(tips, grp)
    v = quat_rotate(tq, gdata["axis"])
    f = torch.clamp(torch.sum(v * gdata["direction"], dim=-1), min=0.0)
    return f * f


def _eval_direction(problem, grp, gdata, tips, qa, data):
    _, tq = _tip_pq(tips, grp)
    v = quat_rotate(tq, gdata["axis"])
    return torch.sum(torch.square(v - gdata["direction"]), dim=-1)


def _eval_cone(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    v = quat_rotate(tq, gdata["axis"])
    dirs = gdata["direction"]
    crs = torch.linalg.vector_norm(cross(v, dirs), dim=-1)
    dot = torch.sum(v * dirs, dim=-1)
    d = torch.clamp(torch.atan2(crs, dot) - gdata["angle"], min=0.0)
    ep = torch.sum(torch.square(gdata["position"] - tp), dim=-1)
    return d * d + gdata["position_weight_sq"] * ep


# ---- joint-space goals (reference: goal_types.h:379-499) -----------------
# each returns (..., count): the same per-lane error for every instance


def _per_instance(e, grp):
    return e[..., None].expand(e.shape + (grp.count,))


def _eval_ajl(problem, grp, gdata, tips, qa, data):
    d = torch.abs(qa - problem.amid) * 2.0 - problem.aspan * 0.5
    d = torch.clamp(d, min=0.0) * problem.velocity_weights * problem.abounded
    return _per_instance(torch.sum(d * d, dim=-1), grp)


def _eval_cj(problem, grp, gdata, tips, qa, data):
    d = (qa - problem.amid) * problem.velocity_weights * problem.abounded
    return _per_instance(torch.sum(d * d, dim=-1), grp)


def _eval_reg(problem, grp, gdata, tips, qa, data):
    d = qa - data["seed_active"]
    return _per_instance(torch.sum(d * d, dim=-1), grp)


def _eval_md(problem, grp, gdata, tips, qa, data):
    d = (qa - data["seed_active"]) * problem.velocity_weights
    return _per_instance(torch.sum(d * d, dim=-1), grp)


def _gather_goal_vars(problem, grp, qa, data):
    """Variable values for goal variables: from ``qa`` when active, else
    from the seed (reference: GoalContext::getVariablePosition negative-
    index convention, goal.h:70-77)."""
    dev = qa.device
    from_active = qa[..., grp.index("slot", dev)]
    from_seed = data["seed_full"][..., grp.index("vidx", dev)]
    return torch.where(grp.index("active", dev), from_active,
                       from_seed.to(from_active.dtype))


def _eval_jv(problem, grp, gdata, tips, qa, data):
    vals = _gather_goal_vars(problem, grp, qa, data)
    d = vals - gdata["target"]
    return d * d


# ---- the kinds only the island path evaluates (JAX problem.py:533-760) ---


def _eval_touch(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    # world-space surface points (..., k, P, 3) and their signed distances;
    # a point with radius r stands for a sphere, whose deepest extent along
    # the normal is its center's signed distance minus r
    world = tp[..., None, :] + quat_rotate(tq[..., None, :], gdata["points"])
    sd = torch.sum((world - gdata["position"][..., None, :])
                   * gdata["normal"][..., None, :], dim=-1)
    d = torch.amin(sd - gdata["radii"], dim=-1)
    return d * d


def _eval_link_function(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    return grp.static["function"](tp[..., 0, :], tq[..., 0, :])[..., None]


def _eval_jf(problem, grp, gdata, tips, qa, data):
    vals = _gather_goal_vars(problem, grp, qa, data)
    preferred = grp.static["function"](vals)
    return torch.sum(torch.square(preferred - vals), dim=-1)[..., None]


def _eval_balance(problem, grp, gdata, tips, qa, data):
    tp, tq = _tip_pq(tips, grp)
    coms = grp.index("coms", tips.device).to(tips.dtype)
    mass = grp.index("mass_frac", tips.device).to(tips.dtype)
    com = torch.sum((tp + quat_rotate(tq, coms)) * mass[:, None], dim=-2)
    d = com - gdata["target"][..., 0, :]
    axis = gdata["axis"][..., 0, :]
    d = d - axis * torch.sum(axis * d, dim=-1, keepdim=True)
    return torch.sum(d * d, dim=-1)[..., None]


_EVALUATORS = {
    "position": _eval_position,
    "orientation": _eval_orientation,
    "pose": _eval_pose,
    "lookat": _eval_lookat,
    "max_distance": _eval_maxd,
    "min_distance": _eval_mind,
    "line": _eval_line,
    "plane": _eval_plane,
    "side": _eval_side,
    "direction": _eval_direction,
    "cone": _eval_cone,
    "avoid_joint_limits": _eval_ajl,
    "center_joints": _eval_cj,
    "regularization": _eval_reg,
    "minimal_displacement": _eval_md,
    "joint_variable": _eval_jv,
    "touch": _eval_touch,
    "link_function": _eval_link_function,
    "joint_function": _eval_jf,
    "balance": _eval_balance,
}
