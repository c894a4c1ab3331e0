"""``params`` and ``profiling`` against the JAX package (CPU), and the
``counter`` statistics of the port's entry points.

Every ``GOAL_TYPES`` entry built from the same dict gives the same problem
in both packages (its groups and every ``make_data`` leaf); configurations
map field for field; ``load_yaml`` and ``solver_from_spec`` read the same
specs; ``SolveStats`` summarizes the same results alike.  Port-only:
``counter=True`` on ``solve_batch``, ``solve_until`` (both branches) and
``AdaptiveBatchSolver``; ``PhaseTimer``, ``annotate`` and ``trace``.
"""

import dataclasses
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu import params as jparams
from bio_ik_tpu.problem import Problem as JProblem
from bio_ik_tpu.profiling import SolveStats as JSolveStats

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import AdaptiveBatchSolver, IKSolver, IKResult, RobotModel, make_fk
from bio_ik_tpu_torch import params
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.problem import Problem
from bio_ik_tpu_torch.profiling import PhaseTimer, SolveStats, annotate, trace

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"

# one dict per GOAL_TYPES entry, in both array and {x, y, z} struct forms
GOAL_DICTS = {
    "position": {"link": TIP, "position": [0.5, -0.2, 0.6], "weight": 2.0},
    "orientation": {"link": TIP, "orientation": {"x": 0, "y": 0, "z": 0.6, "w": 0.8}},
    "pose": {"link": TIP, "position": {"x": 0.5, "y": 0.1, "z": 0.7},
             "orientation": [0.0, 0.6, 0.0, 0.8], "rotation_scale": 0.3},
    "look_at": {"link": TIP, "axis": [1, 0, 0], "target": [1.0, 0.2, 0.5]},
    "lookat": {"link": TIP, "axis": {"x": 0, "y": 1, "z": 0}, "target": [1.0, 0.2, 0.5]},
    "max_distance": {"link": TIP, "target": [0.5, -0.2, 0.6], "distance": 0.2},
    "min_distance": {"link": TIP, "target": [0.5, -0.2, 0.6], "distance": 0.6},
    "line": {"link": TIP, "position": [0.5, -0.2, 0.6], "direction": [0, 3, 4]},
    "plane": {"link": TIP, "position": [0.5, -0.2, 0.6], "normal": [0, 0, 2]},
    "touch": {"link": TIP, "position": [0.5, -0.2, 0.6], "normal": [0, 0, 1],
              "points": [[0, 0, 0], {"x": 0.1, "y": 0, "z": 0}]},
    "avoid_joint_limits": {"weight": 0.5},
    "center_joints": {"weight": 0.3, "secondary": False},
    "regularization": {"weight": 0.2},
    "minimal_displacement": {"weight": 0.4},
    "joint_variable": {"variable_name": "r_elbow_flex_joint", "variable_position": -0.5},
    "joint_function": {"variable_names": ["r_shoulder_pan_joint"],
                       "function": lambda v: v * 0.5},
    "balance": {"target": [0.1, 0.0, 0.0], "axis": [0, 0, 1], "weight": 0.7},
    "link_function": {"link": TIP, "function": lambda p, q: (p * p).sum(-1)},
    "side": {"link": TIP, "axis": [0, 0, 1], "direction": [1, 0, 0]},
    "direction": {"link": TIP, "axis": [0, 0, 1], "direction": [1, 0, 0]},
    "cone": {"link": TIP, "axis": [0, 0, 1], "direction": [1, 0, 0], "angle": 0.3,
             "position": [0.5, -0.2, 0.6], "position_weight": 0.5},
}


@pytest.fixture(scope="module")
def arms():
    return (JRobotModel.from_urdf_file(asset_path("pr2_arm.urdf")),
            RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu"))


def _same_problem(jp, tp, q):
    """The two packages' problems compile alike: tips, active variables,
    groups, and every ``make_data`` leaf."""
    assert tp.tip_links == jp.tip_links and tp.active_vars == jp.active_vars
    for side in ("primary", "secondary"):
        assert [(g.kind, g.goal_type, g.tip_slots.tolist()) for g in getattr(tp, side)] == [
            (g.kind, g.goal_type, g.tip_slots.tolist()) for g in getattr(jp, side)]
    jd = jax.tree.map(np.asarray, jp.make_data(jnp.asarray(q)))
    td = tree_map(lambda x: x.numpy(), tp.make_data(torch.as_tensor(q)))
    assert jax.tree.structure(jd) == jax.tree.structure(td)
    for a, b in zip(jax.tree.leaves(td), jax.tree.leaves(jd)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_goal_types_are_jax_goal_types():
    assert sorted(params.GOAL_TYPES) == sorted(jparams.GOAL_TYPES) == sorted(GOAL_DICTS)
    for name, cls in params.GOAL_TYPES.items():
        assert cls.__name__ == jparams.GOAL_TYPES[name].__name__
        assert cls.__module__ == "bio_ik_tpu_torch.goals"


@pytest.mark.parametrize("tname", sorted(GOAL_DICTS))
def test_goal_from_dict_builds_the_jax_problem(tname, arms):
    """The goal built from the same dict in each package, beside a PoseGoal,
    gives equal problems: groups and ``make_data`` leaves."""
    jm, tm = arms
    d = {"type": tname, **GOAL_DICTS[tname]}
    pose = {"type": "pose", "link": TIP}
    jp = JProblem(jm, jparams.goals_from_dict([pose, d]))
    tp = Problem(tm, params.goals_from_dict([pose, d]))
    tg = params.goal_from_dict(d)
    jg = jparams.goal_from_dict(d)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    _same_problem(jp, tp, tm.neutral_q() + 0.1)


def test_config_from_dict_matches_jax():
    """Field for field, with the reference's ROS names (threads,
    random_seed); an unknown key raises in both packages."""
    d = {"mode": "gd_c_4", "threads": 3, "random_seed": 9, "dtwist": 1e-3,
         "dtype": "float64", "counter": True, "linear_fitness": True,
         "goals": [{"type": "pose", "link": TIP}]}
    assert dataclasses.asdict(params.config_from_dict(d)) == dataclasses.asdict(
        jparams.config_from_dict(d))
    c = params.config_from_dict(d)
    assert (c.islands, c.seed, c.dtype) == (3, 9, "float64")
    for mod in (params, jparams):
        with pytest.raises(ValueError, match="unknown config key"):
            mod.config_from_dict({"timeout": 1.0})
        with pytest.raises(ValueError, match="unknown goal type"):
            mod.goal_from_dict({"type": "nope"})
        with pytest.raises(ValueError, match="expected 3 components"):
            mod.goal_from_dict({"type": "position", "position": [1, 2]})


def test_load_yaml_and_solver_from_spec_match_jax(arms, tmp_path):
    """A kinematics.yaml with a goals list: the same config and goals in
    both packages, and ``solver_from_spec`` the same problem (with a fixed
    joint) as the hand-built one."""
    jm, tm = arms
    path = tmp_path / "kinematics.yaml"
    path.write_text(
        "mode: bio1\nthreads: 2\ndtwist: 1.0e-3\nrotation_scale: 0.5\n"
        "goals:\n"
        "  - type: pose\n    link: r_gripper_tool_frame\n"
        "    position: {x: 0.5, y: -0.2, z: 0.6}\n    orientation: [0, 0, 0, 1]\n"
        "  - type: avoid_joint_limits\n    weight: 0.5\n"
        "  - type: joint_variable\n    variable_name: r_elbow_flex_joint\n"
        "    variable_position: -0.4\n")
    cfg, goals = params.load_yaml(str(path))
    jcfg, jgoals = jparams.load_yaml(str(path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.asdict(g) for g in goals] == [dataclasses.asdict(g) for g in jgoals]
    assert (cfg.mode, cfg.islands) == ("bio1", 2)

    spec = {**dataclasses.asdict(cfg), "goals": [
        {"type": "pose", "link": TIP, "position": [0.5, -0.2, 0.6]},
        {"type": "avoid_joint_limits", "weight": 0.5}],
        "fixed_joints": ["r_wrist_roll_joint"]}
    s = params.solver_from_spec(tm, spec)
    js = jparams.solver_from_spec(jm, spec)
    hand = IKSolver(tm, [G.PoseGoal(link=TIP, position=(0.5, -0.2, 0.6)),
                         G.AvoidJointLimitsGoal(weight=0.5)], cfg,
                    fixed_joints=["r_wrist_roll_joint"])
    assert s.config == hand.config and s.islands == hand.islands == 2
    assert s.problem.active_vars == hand.problem.active_vars == list(range(6))
    _same_problem(js.problem, s.problem, tm.neutral_q())
    _same_problem(js.problem, hand.problem, tm.neutral_q())


# ---------------------------------------------------------------------------
# SolveStats and counter


def test_solve_stats_summary_matches_jax(rng):
    """The same results recorded in both packages' ``SolveStats`` give the
    same summary and report."""
    js, ts = JSolveStats(), SolveStats()
    for b, steps in ((5, 16), (1, 8), (3, 4)):
        ok = rng.uniform(size=b) < 0.6
        fit = rng.uniform(size=b).astype(np.float32)
        q = np.zeros((b, 7), np.float32)
        if b == 1:
            ok, fit, q = ok[0], fit[0], q[0]
        js.record(type("R", (), dict(success=ok, fitness=fit))(), 0.25 * b, steps)
        ts.record(IKResult(q=torch.as_tensor(q), success=torch.as_tensor(ok),
                           fitness=torch.as_tensor(fit), qa=torch.as_tensor(q)),
                  0.25 * b, steps)
    jsum, tsum = js.summary(), ts.summary()
    assert tsum.keys() == jsum.keys()
    for k in jsum:
        assert np.isclose(tsum[k], jsum[k], rtol=1e-6), k
    assert ts.report() == js.report()


def test_counter_records_every_entry_point(arms, caplog):
    """``counter=True``: ``solve_batch`` records its budget (no log line),
    ``solve_until`` the steps it ran — on the fused branch (the plain
    megastep here) and on the island branch (bio1) — each beside the
    solver's ``last_steps`` and a log line; the host-side adaptive ladder
    records in each phase it runs."""
    tm = arms[1]
    q0 = tm.neutral_q()
    b = tm._np_bounds
    tgt = make_fk(tm, [TIP])(torch.as_tensor(np.clip(q0 + 0.1, b["min"], b["max"]),
                                             dtype=torch.float32))
    for mode in ("bio2_memetic", "bio1"):
        s = IKSolver(tm, [G.PoseGoal(link=TIP)], params.config_from_dict(dict(
            mode=mode, counter=True, dtwist=1e-3, max_steps=4, steps_per_check=2,
            islands=1)))
        assert (s.engine is not None) == (mode == "bio2_memetic")
        d = s.make_data(q0)
        d["primary"][0]["position"], d["primary"][0]["orientation"] = tgt.pos[0], tgt.quat[0]
        with caplog.at_level(logging.INFO, logger="bio_ik_tpu_torch"):
            caplog.clear()
            s.solve_until(q0, key=[0, 1], data=d)
        assert s.stats.steps == s.last_steps > 0 and s.stats.batches == 1
        assert f"ik solve: {s.last_steps} steps x 1 islands" in caplog.text
    B = 2
    data = tree_map(lambda x: x.expand((B,) + x.shape).clone(), s.make_data(q0))
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="bio_ik_tpu_torch"):
        s.solve_batch(torch.tensor([[0, 1], [0, 2]]), data)
    assert s.stats.queries == 3 and s.stats.steps == s.last_steps + 4 and not caplog.text
    a = AdaptiveBatchSolver(tm, [G.PoseGoal(link=TIP)], params.config_from_dict(dict(
        mode="jac", counter=True, dtwist=1e-9)), phases=((1, 1), (1, 1)))
    a.solve_batch(torch.tensor([[0, 1], [0, 2]]), data)
    assert [p.stats.queries for p in a.solvers] == [2, 2]


def test_phase_timer_annotate_and_trace(tmp_path):
    """``PhaseTimer`` ranks its phases; ``annotate`` names a range that
    ``trace`` records into ``trace.json``."""
    t = PhaseTimer()
    with t.phase("a"):
        torch.ones(8).sum()
    with t.phase("b"):
        pass
    with t.phase("a"):
        pass
    rep = t.report().splitlines()
    assert rep[0].startswith("p") and t.counts == {"a": 2, "b": 1}
    assert {r.split()[-1] for r in rep[1:]} == {"a", "b"}
    with trace(str(tmp_path)):
        with annotate("ik_phase_x"):
            torch.ones(4) + 1
    text = open(os.path.join(tmp_path, "trace.json")).read()
    assert "ik_phase_x" in text
