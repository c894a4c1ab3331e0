"""The port never imports JAX or the JAX package.

A fresh interpreter imports every module of ``bio_ik_tpu_torch`` (found by
walking the package, so a new module is covered without a list) and the
smoke script ``chip_smoke.py``, then fails if ``jax`` or ``bio_ik_tpu`` is
among the loaded modules.  A subprocess, because the test process itself
has both loaded.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import bio_ik_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bio_ik_tpu_torch.__path__, "bio_ik_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bio_ik_tpu"))
print(json.dumps({"modules": names, "jax_modules": bad}))
"""


def test_no_module_of_the_port_imports_jax():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax_modules"] == []
    # the walk found the package's modules, this slice's included
    for name in ("native", "parallel.islands", "parallel.distributed", "tools.bench_suite",
                 "tools.parallel_check", "engine", "kernels.bio2_megastep"):
        assert f"bio_ik_tpu_torch.{name}" in res["modules"]
