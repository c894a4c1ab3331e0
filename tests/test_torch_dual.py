"""The dual-arm paths of the port on the CPU: the (V, K, T) = (17, 2, 2)
megastep body against the JAX package's, the JAX suite's
``pr2_dual_multigoal`` end to end through the port's AdaptiveBatchSolver,
and which problems the fused engine takes on a card.

The megastep body runs the JAX suite's multigoal problem — a PoseGoal on
the right gripper, a LookAtGoal on the left one, MinimalDisplacement and
AvoidJointLimits — on identical inputs and noise tensors
(``kernels/checks.megastep_inputs``), the JAX body eagerly, traced once
for the file.  The CUDA instance is held to the plain version on the card
by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.kernels.bio2_fullstep import array_draw_gen as j_array_draw_gen
from bio_ik_tpu.kernels.bio2_megastep import make_megastep_body as j_make_megastep_body
from bio_ik_tpu.kernels.bio2_step import SpeciesParams as JSpeciesParams

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import AdaptiveBatchSolver, IKSolver, RobotModel, SolverConfig, make_fk
from bio_ik_tpu_torch.engine import FusedBio2Engine
from bio_ik_tpu_torch.interop import tree_from_numpy, tree_map
from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep, array_draw, make_megastep_body
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs
from bio_ik_tpu_torch.problem import _EVALUATORS

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

R, L = "r_gripper_tool_frame", "l_gripper_tool_frame"
TIPS = [R, L]
KINDS = ["pose", "lookat"]
TERMS = ("beta", "gamma")
SP = dict(V=17, K=2, C=4, gens=1, mem_iters=2, memetic="q")
# tools/bench_suite.py:216-227
MULTIGOAL_CFG = dict(mode="bio2_memetic", dpos=1e-2, drot=float("inf"),
                     dtwist=float("inf"))


def _multigoal(lookat=True):
    return ([G.PoseGoal(link=R)]
            + [G.LookAtGoal(link=L, axis=(1.0, 0.0, 0.0), target=(1.0, 0.0, 0.5),
                            weight=0.5)] * lookat
            + [G.MinimalDisplacementGoal(weight=0.2), G.AvoidJointLimitsGoal(weight=0.2)])


@pytest.fixture(scope="module")
def dual():
    return RobotModel.from_urdf_file(asset_path("pr2_dual.urdf"), device="cpu")


def test_wide_megastep_body_matches_jax(dual):
    """One launch of the (17, 2, 2) body, pose + lookat with the two
    regularizers' secondary terms, one step at N = 256: lane agreement
    ≥ 0.9 with the JAX body (measured 1.0 over two steps)."""
    jm = JRobotModel.from_urdf_file(asset_path("pr2_dual.urdf"))
    state, consts, noise = megastep_inputs(dual, TIPS, SpeciesParams(**SP), 1, 256,
                                           inst_kind=KINDS, sec_terms=TERMS)
    assert len(consts) == 12                  # gaux after gquat, sec at the end
    body, F = make_megastep_body(dual, TIPS, list(range(17)), [0, 1],
                                 SpeciesParams(**SP), 1, sec_terms=TERMS, inst_kind=KINDS)
    jbody, jF = j_make_megastep_body(jm, TIPS, list(range(17)), [0, 1],
                                     JSpeciesParams(**SP), 1, use_pltpu_roll=False,
                                     sec_terms=TERMS, inst_kind=KINDS, unroll=True)
    assert F == jF == 0
    t_out = body(tree_from_numpy(state, "cpu"), tree_from_numpy(consts, "cpu"),
                 array_draw(*tree_from_numpy(noise[:4], "cpu"), SP["gens"],
                            keep=torch.from_numpy(noise[4])))
    jn = [jnp.asarray(x) for x in noise]

    def draw(i):
        return (j_array_draw_gen(jn[0], jn[1], jn[4]), jn[2][i], jn[3][i])

    j_out = jbody(tuple(jnp.asarray(x) for x in state),
                  tuple(jnp.asarray(x) for x in consts), draw)
    assert lane_agreement(t_out, [np.asarray(x) for x in j_out]).float().mean() >= 0.9


def test_wide_wrapper_takes_the_plain_version_on_cpu(dual):
    """The (17, 2, 2) instance's wrapper: the wide source, 16 dependency
    columns (each gripper on the torso and its own arm), the gaux const,
    and on CPU tensors the plain body, no launch counted."""
    sp = SpeciesParams(**SP)
    mega = Megastep(dual, TIPS, list(range(17)), [0, 1], sp, 1, sec_terms=TERMS,
                    inst_kind=KINDS)
    assert mega.source == "megastep_wide" and mega.ncol == 16
    assert mega.groups == (1, 2, 4) and "gaux" in mega.const_names
    state, consts, noise = tree_from_numpy(megastep_inputs(
        dual, TIPS, sp, 1, 32, inst_kind=KINDS, sec_terms=TERMS), "cpu")
    Megastep.launches = 0
    out = mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
               wipe_g=noise[3], keep=noise[4])
    ref = mega.body(state, consts, array_draw(*noise[:4], sp.gens, keep=noise[4]))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert Megastep.launches == 0
    with pytest.raises(ValueError, match="gaux"):
        mega(state, consts[:3] + consts[4:], noise=noise[0], rates=noise[1],
             wipe_u=noise[2], wipe_g=noise[3], keep=noise[4])


def test_multigoal_solve_cpu(dual):
    """The JAX suite's ``pr2_dual_multigoal`` problem through the port's
    AdaptiveBatchSolver on the CPU at B = 8, a 20 + 8-step ladder (the
    suite's runs 32 + 32 + 64 + 128 steps): successes, flags that the
    acceptance test re-derives from the returned q, and a lookat error
    far below that of a solve without the LookAtGoal (measured 1.5e-6
    against 2.7; success 0.75)."""
    B = 8
    b = dual._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"], size=(B, 17)).astype(np.float32)
    tg = make_fk(dual, [R])(torch.from_numpy(qg))
    keys = torch.stack([torch.zeros(B, dtype=torch.int64), torch.arange(B)], -1)

    def solve(s=None):
        s = s or AdaptiveBatchSolver(dual, _multigoal(), SolverConfig(**MULTIGOAL_CFG),
                                     phases=((1, 20), (2, 8)), fractions=(0.25,))
        data = tree_map(lambda x: x.expand((B,) + x.shape).clone(),
                        s.make_data(torch.as_tensor(dual.neutral_q())))
        data["primary"][0]["position"] = tg.pos
        data["primary"][0]["orientation"] = tg.quat
        return s, data, s.solve_batch(keys, data)

    s, data, res = solve()
    eng = s.solvers[0].engine
    assert eng.fullstep and eng.inst_kind == KINDS and eng.sec_terms == TERMS
    p = s.problem
    fk = make_fk(dual, p.tip_links)
    assert torch.equal(p.check_solution(fk(res.q), res.qa, data), res.success)
    assert float(res.success.float().mean()) >= 0.5
    # without the LookAtGoal (4 steps: the gripper's aim is left to chance
    # however long it runs)
    _, _, res0 = solve(IKSolver(dual, _multigoal(lookat=False), SolverConfig(
        **MULTIGOAL_CFG, max_steps=4, steps_per_check=4, islands=1)))

    def lookat_err(q):
        t = fk(q)
        tips = torch.cat([t.pos, t.quat], -1)
        return _EVALUATORS["lookat"](p, p.primary[1], data["primary"][1], tips, None,
                                     None)[:, 0]

    assert float(lookat_err(res.q).median()) < 1e-3 * float(lookat_err(res0.q).median())


def _on_card(solver):
    solver.problem.device = torch.device("cuda")   # metadata only
    return FusedBio2Engine.supports(solver)


def test_card_takes_the_dual_paths_and_names_the_gaps(dual):
    """On a card the fused engine takes ``pr2_dual_pose2`` and
    ``pr2_dual_multigoal`` (the wide instance) and ``snake32_position`` and
    ``humanoid_whole_body`` (the high-DOF instances, with and without the
    regularizers), rejects the shapes no source instantiates (ROADMAP item
    9: the snake with a joint fixed), non-pose primaries on a narrow
    (pose-family) instance and on a floating chain."""
    pose2 = IKSolver(dual, [G.PoseGoal(link=R), G.PoseGoal(link=L)])
    assert _on_card(pose2) is None
    assert _on_card(IKSolver(dual, _multigoal(), SolverConfig(**MULTIGOAL_CFG))) is None
    regs = [G.MinimalDisplacementGoal(weight=0.05), G.AvoidJointLimitsGoal(weight=0.05)]
    for urdf, goals in (("snake.urdf", [G.PositionGoal(link="head")]),
                        ("humanoid.urdf", [G.PoseGoal(link=t)
                                           for t in ("r_hand", "l_hand", "head")])):
        m = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
        assert _on_card(IKSolver(m, goals)) is None
        assert _on_card(IKSolver(m, goals + regs)) is None
    snake = RobotModel.from_urdf_file(asset_path("snake.urdf"), device="cpu")
    reason = _on_card(IKSolver(snake, [G.PositionGoal(link="head")],
                               fixed_joints=[snake.joint_names[2]]))
    assert "not instantiated" in reason and "(31, 1, 1)" in reason
    assert "queue item 9" in reason
    arm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    look = IKSolver(arm, [G.LookAtGoal(link=R)])
    assert look.engine is not None                 # CPU: the plain version
    reason = _on_card(look)
    assert "pose family only" in reason and "queue item 9" in reason
    free = RobotModel.from_urdf_file(asset_path("free_arm.urdf"), device="cpu")
    s = IKSolver(free, [G.LookAtGoal(link="tool")])
    assert s.engine is None and "fullstep kernel" in s.unsupported


def test_counter_names_its_roadmap_item(dual):
    """``SolverConfig(counter=True)`` asks for per-solve statistics
    (JAX ``IKSolver.stats``, a ``SolveStats``): the port raises until
    ROADMAP item 6 ports them."""
    with pytest.raises(NotImplementedError, match="port queue item 6"):
        IKSolver(dual, [G.PoseGoal(link=R)], SolverConfig(counter=True))
    with pytest.raises(NotImplementedError, match="port queue item 6"):
        AdaptiveBatchSolver(dual, [G.PoseGoal(link=R)], SolverConfig(counter=True))


def test_port_bench_prints_bench_py_keys(monkeypatch):
    """``python -m bio_ik_tpu_torch.tools.bench`` (the port's copy of
    bench.py) on the CPU at B = 4 with two steps a phase: bench.py's keys,
    its configuration, successes counted as solves."""
    from bio_ik_tpu_torch.tools import bench

    assert bench.PHASES == ((1, 24), (2, 32), (4, 64), (8, 32))
    assert bench.FRACTIONS == (0.15, 0.03, 0.008)
    monkeypatch.setattr(bench, "PHASES", tuple((i, 2) for i, _ in bench.PHASES))
    out = bench.run(batch=4, queue=1, repeats=1, device="cpu")
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "success_rate",
                        "batch", "phases", "batch_time_ms", "median_pos_err_m",
                        "note", "device"}
    assert out["batch"] == 4 and out["device"] == "cpu" and out["unit"] == "solves/s"
    assert out["phases"] == "1x2,2x2,4x2,8x2 adaptive"
    # successes per second of batch time (both rounded in the line)
    assert np.isclose(out["value"], 4 * out["success_rate"] / (out["batch_time_ms"] / 1e3),
                      rtol=1e-2, atol=0.1)
