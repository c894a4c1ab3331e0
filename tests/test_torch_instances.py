"""Kernel instances for every shape the fused engine takes (CPU, no JAX).

On a card the megastep and species kernels run from one compiled instance
per shape: a prebuilt source of ``csrc/`` (``MEGASTEP_SOURCES``,
``SPECIES_SHAPES``), or a source generated for the shape and built on its
first use (``bio2_megastep.megastep_instance``,
``bio2_step.species_instance``, ``kernels/build.generate``).  These tests
hold the resolution on the JAX package's own fused configurations, the
generated text and its library's hash, the Python copy of the kernels'
shared-memory layout, and ``FusedBio2Engine.card_reason``; the generated
instances themselves are held to their plain versions on the card (the
``cuda``-marked test here, and ``chip_smoke.py``'s ``shapes_check``).
"""

import os
import shutil

import pytest
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import AdaptiveBatchSolver, IKSolver, RobotModel, SolverConfig, asset_path
from bio_ik_tpu_torch.engine import FusedBio2Engine
from bio_ik_tpu_torch.kernels import build
from bio_ik_tpu_torch.kernels.bio2_megastep import (MEGASTEP_SOURCES, Megastep,
                                                    megastep_instance, megastep_smem_bytes)
from bio_ik_tpu_torch.kernels.bio2_step import (SMEM_OPTIN, SPECIES_SHAPES, SpeciesParams,
                                                sec_term_mask, species_instance,
                                                species_smem_bytes)

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

ARM = "r_gripper_tool_frame"
DUAL = ("r_gripper_tool_frame", "l_gripper_tool_frame", "head_tilt_link")
LOOK = dict(axis=(1.0, 0.0, 0.0), target=(1.0, 0.0, 0.5), weight=0.5)
REGS = (("minimal_displacement", 0.1), ("avoid_joint_limits", 0.1))
_models = {}


def _model(urdf):
    if urdf not in _models:
        _models[urdf] = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
    return _models[urdf]


def _goals(spec):
    goals = []
    for kind, link in spec:
        if kind == "lookat":
            goals.append(G.LookAtGoal(link=link, **LOOK))
        elif kind == "line":
            goals.append(G.LineGoal(link=link))
        elif kind == "max_distance":
            goals.append(G.MaxDistanceGoal(link=link, distance=1.0))
        elif kind == "cone":
            goals.append(G.ConeGoal(link=link))
        elif kind == "minimal_displacement":
            goals.append(G.MinimalDisplacementGoal(weight=link))
        elif kind == "avoid_joint_limits":
            goals.append(G.AvoidJointLimitsGoal(weight=link))
        else:
            goals.append({"position": G.PositionGoal, "orientation": G.OrientationGoal,
                          "pose": G.PoseGoal}[kind](link=link))
    return goals


# (id, urdf, goals, the instance's shape — (V, K, T) on the fullstep tier,
# (V, K, quaternion mask) on the species tier —, its source, groups).  The
# first nine are the JAX package's fused configurations that no prebuilt
# instance holds (tests/test_kernel.py:101-106, :535-538,
# tests/test_multigoal.py:36-40, and the other robots' like them); the rest
# the prebuilt instances' own paths
CONFIGS = [
    ("pr2_arm_pose_lookat", "pr2_arm.urdf", [("pose", ARM), ("lookat", ARM)],
     (7, 2, 1), "megastep_gen_7_2_1_g48", (4, 8)),
    ("pr2_arm_position_lookat", "pr2_arm.urdf", [("position", ARM), ("lookat", ARM)],
     (7, 2, 1), "megastep_gen_7_2_1_g48", (4, 8)),
    ("pr2_arm_pose_line_maxd_cone", "pr2_arm.urdf",
     [("pose", ARM), ("line", ARM), ("max_distance", ARM), ("cone", ARM)],
     (7, 4, 1), "megastep_gen_7_4_1_g48", (4, 8)),
    ("pr2_dual_multigoal_head", "pr2_dual.urdf",
     [("pose", DUAL[0]), ("pose", DUAL[1]), ("lookat", DUAL[2])] + list(REGS),
     (17, 3, 3), "megastep_gen_17_3_3_g4816", (4, 8, 16)),
    ("pr2_dual_one_pose", "pr2_dual.urdf", [("pose", DUAL[0])],
     (17, 1, 1), "megastep_gen_17_1_1_g4816", (4, 8, 16)),
    ("ur5_pose_lookat", "ur5.urdf", [("pose", "tool0"), ("lookat", "tool0")],
     (6, 2, 1), "megastep_gen_6_2_1_g48", (4, 8)),
    ("humanoid_two_hands", "humanoid.urdf", [("pose", "r_hand"), ("pose", "l_hand")],
     (30, 2, 2), "megastep_gen_30_2_2_g816", (8, 16)),
    ("free_arm_position_orientation", "free_arm.urdf",
     [("position", "tool"), ("orientation", "tool")], (10, 2, 8), "species_gen_10_2_8", None),
    ("planar_arm_position_orientation", "planar_arm.urdf",
     [("position", "tool"), ("orientation", "tool")], (5, 2, 0), "species_gen_5_2_0", None),
    ("pr2_arm_lookat_alone", "pr2_arm.urdf", [("lookat", ARM)],
     (7, 1, 1), "megastep_gen_7_1_1_g48", (4, 8)),
    ("pr2_arm_pose", "pr2_arm.urdf", [("pose", ARM)], (7, 1, 1), "megastep", (1, 2, 4, 8)),
    ("ur5_pose", "ur5.urdf", [("pose", "tool0")], (6, 1, 1), "megastep", (1, 2, 4, 8)),
    ("pr2_dual_pose2", "pr2_dual.urdf", [("pose", DUAL[0]), ("pose", DUAL[1])],
     (17, 2, 2), "megastep_wide", (4, 8, 16)),
    ("snake32_position", "snake.urdf", [("position", "head")] + list(REGS),
     (32, 1, 1), "megastep_high", (8, 16)),
    ("humanoid_whole_body", "humanoid.urdf",
     [("pose", "r_hand"), ("pose", "l_hand"), ("pose", "head")],
     (30, 3, 3), "megastep_high", (8, 16)),
    ("free_arm_position", "free_arm.urdf", [("position", "tool")], (10, 1, 8), "species", None),
]


def _on_card(solver):
    solver.problem.device = torch.device("cuda")      # metadata only
    return FusedBio2Engine.shared_reason(solver), FusedBio2Engine.card_reason(solver)


@pytest.mark.parametrize("cid,urdf,spec,shape,source,groups", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_every_fused_configuration_resolves_to_an_instance(cid, urdf, spec, shape,
                                                           source, groups):
    """The JAX engine fuses the configuration (``shared_reason`` None), the
    card takes it (``card_reason`` None), and the engine's kernel resolves
    to the expected prebuilt or generated instance, layout and group
    sizes."""
    s = IKSolver(_model(urdf), _goals(spec))
    eng = s.engine
    assert eng is not None and _on_card(s) == (None, None)
    if groups is None:                                  # the species tier
        assert not eng.fullstep
        assert (eng.sp.V, eng.sp.K, shape[2]) == shape and eng.kernel.source == source
        assert (source == "species") == (shape in SPECIES_SHAPES)
        return
    inst = eng.mega.instance
    assert (eng.sp.V, eng.sp.K, eng.mega.T) == shape
    assert inst.source == source and inst.groups == groups
    assert inst.generated == source.startswith("megastep_gen_")
    assert inst.wide == (source != "megastep")
    assert eng.mega.ncol == (0 if source == "megastep" else eng.mega._wide_ncol)
    if inst.generated:
        assert not any(shape in shapes for src, shapes in MEGASTEP_SOURCES.items()
                       if src != "megastep")


def test_generated_source_text_and_its_hash(tmp_path, monkeypatch):
    """A generated instance is its SHAPES, GROUPS and MEGASTEP_WIDE lines and
    the header's include (the species one: SHAPES and species.cuh, built
    -fmad=false); its library is named by a hash that is stable, does not
    depend on the checkout's path, and changes with an edit of a
    ``csrc/*.cuh`` header."""
    inst = Megastep(_model("pr2_arm.urdf"), [ARM], list(range(7)), [0, 0],
                    SpeciesParams(V=7, K=2), 1, inst_kind=("pose", "lookat")).instance
    text, flags = build._generated[inst.source]
    assert "#define SHAPES(X) X(7, 2, 1)\n" in text
    assert "#define GROUPS(X, v, k, t) X(v, k, t, 4) X(v, k, t, 8)\n" in text
    assert "#define MEGASTEP_WIDE 1\n" in text and '#include "megastep.cuh"' in text
    assert flags == ["--split-compile=0"]
    assert build.source_path(inst.source) == os.path.join(build.GEN_DIR,
                                                          inst.source + ".cu")
    sname = species_instance(10, 2, 8)
    stext, sflags = build._generated[sname]
    assert "#define SHAPES(X) X(10, 2, 8)\n" in stext and '#include "species.cuh"' in stext
    assert sflags == ["-fmad=false"] and species_instance(10, 1, 8) == "species"
    with pytest.raises(ValueError, match="csrc"):
        build.generate("megastep_wide", text)

    def target(csrc, name):
        monkeypatch.setattr(build, "CSRC", str(csrc))
        return os.path.basename(build._target(name))

    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(build.CSRC, a)
    shutil.copytree(build.CSRC, b)
    names = (inst.source, sname, "species", "megastep")
    first = [target(a, n) for n in names]
    assert first == [target(a, n) for n in names] == [target(b, n) for n in names]
    assert "-I" in build._flags(inst.source) and "-I" not in build._flags("megastep")
    for header in ("megastep.cuh", "species.cuh"):
        with open(b / header, "a") as f:
            f.write("// edited\n")
        changed = [target(b, n) for n in names]
        assert all(x != y for x, y in zip(first, changed))
        first = changed


def test_a_source_building_in_another_thread_is_waited_for(tmp_path, monkeypatch):
    """Two threads asking for one source run one ``nvcc`` between them, and
    both return once its library is there (a build started in the
    background serves the first use of its kernels); a failed build raises
    in the thread that waited for it too.  ``nvcc`` is a stand-in script."""
    import sys
    import threading

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys, time\n"
                    f"open({str(calls)!r}, 'a').write('x')\n"
                    "time.sleep(0.5)\n"
                    "if 'fail' in sys.argv[-1]: sys.exit(1)\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "GEN_DIR", str(tmp_path / "kernels" / "gen"))
    for name in ("bg_ok", "bg_fail"):
        monkeypatch.setitem(build._generated, name, (f"// {name}\n", []))
    for name, ok in (("bg_ok", True), ("bg_fail", False)):
        calls.write_text("")
        errors = []

        def ask():
            try:
                build.build_all([name])
            except RuntimeError as e:
                errors.append(e)

        threads = [threading.Thread(target=ask) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert calls.read_text() == "x"
        assert os.path.exists(build._target(name)) is ok
        assert len(errors) == (0 if ok else 2)
    assert not build._building


def test_layout_copy_holds_the_recorded_block_sizes():
    """The Python copy of the wide layout (csrc/megastep_wide.cuh) at the
    high-DOF instances: a snake block 38.4 KiB at W = 16 and 43.9 KiB with
    secondary goals (72.7 / 83.7 KiB at W = 8), the humanoid's 36.8 and
    42.0 KiB (70.4 / 80.7) — every block far below the card's limit, where
    the layout that kept a lane in one thread took 164 / 308 and 128 / 264
    KiB at G = 1; the species block of 128 lanes, 110.6 KB at (10, 1, 8) and
    151.6 KB at (10, 2, 8) (csrc/species.cuh)."""
    for urdf, tips, K, want in (("snake.urdf", ["head"], 1, ((74416, 39312), (85680, 44944))),
                                ("humanoid.urdf", ["r_hand", "l_hand", "head"], 3,
                                 ((72056, 37656), (82680, 42968)))):
        m = _model(urdf)
        V = m.nvars
        megas = [Megastep(m, tips, list(range(V)), list(range(K)), SpeciesParams(V=V, K=K),
                          1, sec_terms=terms) for terms in ((), ("beta", "gamma"))]
        assert tuple((mega.smem_bytes_py(8), mega.smem_bytes_py(16)) for mega in megas) == want
        assert max(megas[1].smem_bytes_py(w) for w in megas[1].groups) <= SMEM_OPTIN
    assert species_smem_bytes(10, 1, 16, 0) == 110592
    assert species_smem_bytes(10, 2, 16, 0) == 151552
    assert species_smem_bytes(10, 4, 16, 0) == 233472 > SMEM_OPTIN


def test_generated_instances_build_only_the_group_sizes_that_fit():
    """A generated instance leaves out a group width whose block exceeds the
    card's shared memory (and is named by the rest); where none fits the
    resolver raises, naming the bytes by width.  The wide layout's block
    holds BLOCK / W lanes of a few KB, so it takes many tips and columns:
    (23, 6, 6) with 111 columns drops W = 4 with secondary goals (234 712
    bytes) and keeps it without (218 072); (40, 32, 16) with 640 columns
    fits at no width."""
    sec = sec_term_mask(("beta", "gamma"))
    inst = megastep_instance(23, 6, 6, ["pose"] * 6, sec, chain=(40, 0, 111))
    assert inst.generated and inst.groups == (8, 16)
    assert inst.source == "megastep_gen_23_6_6_g816"
    assert megastep_smem_bytes(23, 40, 0, 16, 4, sec, 111, 6, 6) == 234712 > SMEM_OPTIN
    assert megastep_smem_bytes(23, 40, 0, 16, 4, 0, 111, 6, 6) == 218072
    assert megastep_instance(23, 6, 6, ["pose"] * 6, 0,
                             chain=(40, 0, 111)).groups == (4, 8, 16)
    with pytest.raises(ValueError, match=r"232448 bytes.*\{8: \d+, 16: \d+\} bytes by group size"):
        megastep_instance(40, 32, 16, ["pose"] * 32, sec, chain=(40, 0, 640))


def test_card_reason_names_a_block_that_does_not_fit():
    """On a card, card_reason is a shared-memory reason in bytes only where
    no block fits — four goal instances on the floating arm, 233 472 bytes
    of species block against 232 448 —, and None on the CPU, where the
    plain version runs any shape; nothing falls back on the card."""
    free = _model("free_arm.urdf")
    spec = [("position", "tool"), ("orientation", "tool"), ("pose", "tool"),
            ("position", "tool")]
    s = IKSolver(free, _goals(spec), SolverConfig(dtwist=float("inf")))
    assert s.engine is not None and FusedBio2Engine.card_reason(s) is None
    shared, card = _on_card(s)
    assert shared is None and "233472" in card and "232448" in card
    assert FusedBio2Engine.supports(s) == card and "shared memory" in card
    assert _on_card(IKSolver(free, _goals(spec[:2]))) == (None, None)


def test_warmup_builds_nothing_on_the_cpu():
    """``warmup`` builds the fused engine's instance ahead of the first
    solve on a card; on the CPU there is nothing to build."""
    arm = _model("pr2_arm.urdf")
    assert IKSolver(arm, _goals([("pose", ARM), ("lookat", ARM)])).warmup() == 0.0
    ab = AdaptiveBatchSolver(arm, _goals([("pose", ARM)]), phases=((1, 2), (2, 2)),
                             fractions=(0.5,))
    assert ab.warmup() == 0.0


@pytest.mark.cuda
def test_generated_instances_match_their_plain_versions_on_the_card():
    """The generated (7, 2, 1) megastep (pose + lookat) against its plain
    version at 512 lanes, two steps, noise tensors (≥ 0.85 of lanes, as
    ``chip_smoke.py``'s check) and bitwise across its group sizes; the
    generated (10, 2, 8) species instance bitwise against its plain version
    in Philox mode under CLT4."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from bio_ik_tpu_torch.interop import tree_from_numpy
    from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep, array_draw
    from bio_ik_tpu_torch.kernels.bio2_step import SpeciesKernel, SpeciesParams
    from bio_ik_tpu_torch.kernels.checks import (lane_agreement, megastep_inputs,
                                                 species_inputs)

    dev = torch.device("cuda")
    arm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    kinds = ["pose", "lookat"]
    sp = SpeciesParams(V=7, K=2)
    mega = Megastep(arm, [ARM], list(range(7)), [0, 0], sp, 2, inst_kind=kinds)
    assert mega.instance.generated
    state, consts, noise = tree_from_numpy(megastep_inputs(
        _model("pr2_arm.urdf"), [ARM], sp, 2, 512, inst_kind=kinds), dev)
    outs = {g: mega(state, consts, noise=noise[0], rates=noise[1], wipe_u=noise[2],
                    wipe_g=noise[3], group=g) for g in mega.groups}
    plain = mega.body(state, consts, array_draw(*noise, sp.gens))
    g0 = outs[mega.groups[0]]
    assert lane_agreement(g0, plain).float().mean() >= 0.85
    for out in outs.values():
        assert all(torch.equal(a, b) for a, b in zip(out, g0))
    free = _model("free_arm.urdf")
    ssp = SpeciesParams(V=10, K=2, quat_slices=(3,))
    kern = SpeciesKernel(ssp)
    assert kern.source == "species_gen_10_2_8"
    args, kw = species_inputs(free, "tool", ssp, 4096, philox=True,
                              inst_kind=["position", "orientation"])
    args, kw = tree_from_numpy(args, dev), tree_from_numpy(kw, dev)
    out = kern(*args, seed=11, step=3, **kw)
    noise, rates, _ = kern.philox_tensors(11, 3, kw["salt"])
    ref = kern.inner(*args, noise, rates)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


# ---------------------------------------------------------------------------
# shapes_main's quality anchor: the JAX package's fused path and the port's
# plain version on the first 256 of each of chip_smoke.py's shapes_main
# paths' targets, at the path's own ladder

N_ANCHOR = 256


def _chip_smoke():
    """chip_smoke.py's module (its top level imports the standard library
    only): the paths' goals, ladders and JAX_SHAPES_SUCCESS."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes_path(path, goals, smoke):
    """(urdf, goals, config fields, (phases, fractions) or None) of a
    shapes_main path, its goals from the ``goals`` module of either
    package."""
    import math

    if path == "arm_lookat":
        return ("pr2_arm.urdf",
                [goals.PositionGoal(link=ARM), goals.LookAtGoal(link=ARM, **smoke.LOOKAT)],
                dict(mode="bio2_memetic", dpos=1e-2, dtwist=float("inf")),
                (smoke.PHASES, smoke.FRACTIONS))
    if path == "dual_head":
        return ("pr2_dual.urdf",
                [goals.PoseGoal(link=t) for t in smoke.DUAL_TIPS]
                + [goals.LookAtGoal(link=smoke.HEAD, **smoke.LOOKAT),
                   goals.MinimalDisplacementGoal(weight=smoke.DH_WEIGHT),
                   goals.AvoidJointLimitsGoal(weight=smoke.DH_WEIGHT)],
                dict(mode="bio2_memetic", dtwist=1e-2),
                (smoke.DUAL_PHASES, smoke.DUAL_FRACTIONS))
    return ("free_arm.urdf", [goals.PositionGoal(link="tool"), goals.OrientationGoal(link="tool")],
            dict(mode="bio2_memetic", dpos=5e-3, drot=math.degrees(5e-3),
                 dtwist=float("inf"), max_steps=16, islands=smoke.SPECIES_ISLANDS),
            None)


def _fill_targets(problem, data, pos, quat):
    """Each position, orientation or pose goal given its tip's target (the
    FK of the first N_ANCHOR of chip_smoke's uniform draws), a LookAtGoal
    the grippers' midpoint where there are two (shapes_main's path (ii))."""
    for grp, gd in zip(problem.primary, data["primary"]):
        slots = [int(s) for s in grp.tip_slots]
        if grp.goal_type in ("position", "pose"):
            gd["position"] = pos[:, slots]
        if grp.goal_type in ("orientation", "pose"):
            gd["orientation"] = quat[:, slots]
        if grp.kind == "lookat" and pos.shape[1] > 2:
            gd["target"] = 0.5 * (pos[:, 0:1] + pos[:, 1:2])


@pytest.mark.slow
@pytest.mark.parametrize("path", ["arm_lookat", "dual_head", "free_posori"])
def test_shapes_main_success_of_the_jax_package_on_256_targets(path):
    """The JAX package's fused path (plain jnp on the CPU) on the first 256
    of the shapes_main path's targets at its ladder: its success equals
    chip_smoke.py's ``JAX_SHAPES_SUCCESS`` (within one target), whose less
    0.01 is the path's bar where it is below the issue's; the port's plain
    version on the same targets within 0.1 of it.  The JAX ladder is
    ``AdaptiveBatchSolver._adaptive_on_device`` itself — the same phases,
    retry selection, key folding and merge — run eagerly with each phase's
    engine solve its own jitted program: jitted as one program the ladder
    did not finish compiling in an hour on a CPU.  Prints both success
    rates (about 50 min for arm_lookat, 25 for dual_head, 3 for
    free_posori: the JAX compile of each phase)."""
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bio_ik_tpu.goals as JG
    from bio_ik_tpu import RobotModel as JRobotModel
    from bio_ik_tpu.api import AdaptiveBatchSolver as JAdaptiveBatchSolver
    from bio_ik_tpu.api import IKSolver as JIKSolver
    from bio_ik_tpu.config import SolverConfig as JSolverConfig
    from bio_ik_tpu.kinematics import make_fk as j_make_fk
    from bio_ik_tpu_torch import make_fk
    from bio_ik_tpu_torch.interop import tree_map

    smoke = _chip_smoke()
    B = N_ANCHOR
    urdf, jgoals, cfg, ladder = _shapes_path(path, JG, smoke)
    jm = JRobotModel.from_urdf_file(asset_path(urdf))
    js = (JIKSolver(jm, jgoals, JSolverConfig(**cfg)) if ladder is None else
          JAdaptiveBatchSolver(jm, jgoals, JSolverConfig(**cfg), phases=ladder[0],
                               fractions=ladder[1]))
    b = jm._np_bounds
    qg = np.random.default_rng(0).uniform(b["min"], b["max"],
                                          size=(B, jm.nvars)).astype(np.float32)
    jp = js.problem
    jt = j_make_fk(jm, list(jp.tip_links))(jnp.asarray(qg))
    jdata = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                         js.make_data(jnp.asarray(jm.neutral_q())))
    _fill_targets(jp, jdata, jt.pos, jt.quat)
    jkeys = jnp.stack([jnp.zeros(B, jnp.uint32), jnp.arange(B, dtype=jnp.uint32)], -1)
    if ladder is None:
        assert js.engine is not None and not js.engine.fullstep
        jres = js.solve_batch(jkeys, jdata)
    else:
        for solver in js.solvers:
            assert solver.engine is not None and solver.engine.fullstep
            solver.engine._solve_batch = solver.engine._solve_jit
        jres = js._adaptive_on_device(jkeys, jdata)
    jax_success = float(np.mean(np.asarray(jres.success)))

    urdf, goals, cfg, ladder = _shapes_path(path, G, smoke)
    m = _model(urdf)
    s = (IKSolver(m, goals, SolverConfig(**cfg)) if ladder is None else
         AdaptiveBatchSolver(m, goals, SolverConfig(**cfg), phases=ladder[0],
                             fractions=ladder[1]))
    t = make_fk(m, list(s.problem.tip_links))(torch.from_numpy(qg))
    data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q())))
    _fill_targets(s.problem, data, t.pos, t.quat)
    keys = torch.stack([torch.zeros(B, dtype=torch.int64), torch.arange(B)], -1)
    port_success = float(s.solve_batch(keys, data).success.float().mean())
    print(json.dumps({"path": path, "targets": B, "jax_success": jax_success,
                      "port_plain_success": port_success}))
    assert abs(jax_success - smoke.JAX_SHAPES_SUCCESS[path]) <= 1 / B
    assert abs(port_success - jax_success) <= 0.1
