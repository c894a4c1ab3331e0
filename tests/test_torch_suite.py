"""The port's ``bench_suite`` against the JAX package's tool, and the
(6, 1, 1) megastep instance its ``ur5_pose`` row runs (CPU).

* The row table: JAX ``tools/bench_suite.main()`` with its ``run_config``
  replaced by a recorder (no jit, no solve) gives the rows, in order, that
  the port's ``main()`` hands its own ``run_config`` — URDFs, tips, goals,
  ``SolverConfig``s, tolerances, batch caps, phases and fractions.
* The plain megastep at V = 6 (UR5) against the JAX package's plain-jnp
  megastep body on identical inputs, as ``test_torch_megastep.py`` holds it
  at V = 7: per-lane agreement ≥ 0.9 (rtol 1e-5), exact-FK tips and fitness
  within 1e-5 wherever the incumbents agree.
* ``run_config`` of the ``ur5_pose`` row on the CPU prints one JSON line
  with the JAX tool's keys, ``launches`` and ``device``.
"""

import dataclasses
import importlib.util
import inspect
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bio_ik_tpu import RobotModel as JRobotModel, asset_path
from bio_ik_tpu.kernels.bio2_fullstep import array_draw_gen as j_array_draw_gen
from bio_ik_tpu.kernels.bio2_megastep import make_megastep_body as j_make_megastep_body
from bio_ik_tpu.kernels.bio2_step import SpeciesParams as JSpeciesParams

from bio_ik_tpu_torch import RobotModel
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep, array_draw, make_megastep_body
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs
from bio_ik_tpu_torch.tools import bench_suite

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of one row of the JAX tool (tools/bench_suite.py:95-106)
JAX_KEYS = ["config", "solves_per_sec", "success_rate", "frac_pos_err<0.001",
            "median_pos_err_m", "batch", "batch_time_ms", "dof", "engine"]


def _jax_suite():
    """The JAX tool as a module (it sets two options of JAX's persistent
    compilation cache at import; they are put back)."""
    keep = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "jax_bench_suite", os.path.join(ROOT, "tools", "bench_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


def _bound(fn, args, kwargs):
    b = inspect.signature(fn).bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


def _goal(g):
    return type(g).__name__, dataclasses.asdict(g)


def test_rows_equal_the_jax_tools(monkeypatch):
    jsuite = _jax_suite()
    jrows, jreal = [], jsuite.run_config
    monkeypatch.setattr(jsuite, "run_config",
                        lambda *a, **kw: jrows.append(_bound(jreal, a, kw)))
    jsuite.main()
    rows = []
    real = bench_suite.run_config
    monkeypatch.setattr(bench_suite, "run_config",
                        lambda *a, **kw: rows.append(_bound(real, a, kw)))
    monkeypatch.setenv("BENCH_BATCH", str(jsuite.B))
    bench_suite.main(["--device", "cpu"])
    assert [r["name"] for r in rows] == [r["name"] for r in jrows] == list(bench_suite.ROWS)
    assert len(rows) == 12
    for r, j in zip(rows, jrows):
        for k in ("urdf", "tips", "pos_tol", "adaptive", "phases", "fractions"):
            assert r[k] == j[k], (r["name"], k)
        assert r["batch"] == (j["batch"] or jsuite.B), r["name"]
        assert [_goal(g) for g in r["goals"]] == [_goal(g) for g in j["goals"]], r["name"]
        assert dataclasses.asdict(r["cfg"]) == dataclasses.asdict(j["cfg"]), r["name"]
        assert r["device"] == "cpu"
    # selecting rows, in the order asked
    rows.clear()
    bench_suite.main(["--device", "cpu", "--rows", "kuka_iiwa_pose,ur5_pose"])
    assert [r["name"] for r in rows] == ["kuka_iiwa_pose", "ur5_pose"]
    with pytest.raises(SystemExit):
        bench_suite.main(["--device", "cpu", "--rows", "no_such_row"])


def test_megastep_body_at_v6_matches_jax():
    """The (6, 1, 1) shape on UR5's tool0 (the ``ur5_pose`` row), the JAX
    check's sizes (C=4, gens=2, mem_iters=2, two steps, 256 lanes)."""
    jm = JRobotModel.from_urdf_file(asset_path("ur5.urdf"))
    tm = RobotModel.from_urdf_file(asset_path("ur5.urdf"), device="cpu")
    sp = dict(V=6, K=1, C=4, gens=2, mem_iters=2, memetic="q")
    state, consts, noise = megastep_inputs(tm, "tool0", SpeciesParams(**sp), 2, 256)
    body, F = make_megastep_body(tm, ["tool0"], list(range(6)), [0], SpeciesParams(**sp), 2)
    jbody, jF = j_make_megastep_body(jm, ["tool0"], list(range(6)), [0],
                                     JSpeciesParams(**sp), 2, use_pltpu_roll=False,
                                     unroll=True)
    assert F == jF == 0
    mega = Megastep(tm, ["tool0"], list(range(6)), [0], SpeciesParams(**sp), 2)
    # the prebuilt X(6, 1, 1) of csrc/megastep.cu, every group size
    assert mega.instance == ("megastep", False, (1, 2, 4, 8), False)
    t_out = body(tree_from_numpy(state, "cpu"), tree_from_numpy(consts, "cpu"),
                 array_draw(*tree_from_numpy(noise, "cpu"), sp["gens"]))
    jn = [jnp.asarray(x) for x in noise]

    def draw(i):
        g0 = i * sp["gens"]
        return (j_array_draw_gen(jn[0][g0:g0 + sp["gens"]], jn[1][g0:g0 + sp["gens"]]),
                jn[2][i], jn[3][i])

    j_out = [np.asarray(x) for x in jbody(
        tuple(jnp.asarray(x) for x in state), tuple(jnp.asarray(x) for x in consts), draw)]
    assert lane_agreement(t_out, j_out).float().mean() >= 0.9
    sol_ok = lane_agreement([t_out[3]], [j_out[3]])
    assert sol_ok.float().mean() >= 0.9
    tips_ok = lane_agreement([t_out[4], t_out[5]], [j_out[4], j_out[5]], rtol=1e-5, atol=1e-5)
    assert bool(tips_ok[sol_ok].all())


def test_run_config_prints_the_jax_keys(capsys):
    """The ``ur5_pose`` row at B = 8 on the plain versions, its ladder cut
    to 2 steps a phase (the same four phases and fractions)."""
    kw = dict(bench_suite.ROWS["ur5_pose"])
    kw["phases"] = tuple((i, 2) for i, _ in kw["phases"])
    row = bench_suite.run_config("ur5_pose", batch=8, device="cpu", **kw)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == row
    assert list(row) == JAX_KEYS + ["launches", "device"]
    assert row["batch"] == 8 and row["dof"] == 6 and row["engine"] == "fused"
    assert row["launches"] == 0 and row["device"] == "cpu"     # no kernel on the CPU
    assert 0.0 <= row["success_rate"] <= 1.0 and np.isfinite(row["median_pos_err_m"])
