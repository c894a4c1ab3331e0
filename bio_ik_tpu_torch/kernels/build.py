"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout
(the hash is of the source, so an edited source is rebuilt), for
``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

plus the source's own flags in :data:`EXTRA_FLAGS`.  ``-Xptxas -v``
reports each kernel's registers and spills; the report is kept beside the
library as ``<name>.ptxas.txt``.  Nothing here runs at
import time: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

__all__ = ["build", "build_all", "load", "ptxas_report", "BUILD_DIR", "CSRC"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-source flags: the species kernel keeps the plain version's rounding
# (no FMA contraction; see the note at the top of csrc/species.cu)
EXTRA_FLAGS = {"species": ["-fmad=false"]}

_loaded: Dict[str, ctypes.CDLL] = {}


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _target(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log[-8000:]}")
    os.replace(tmp, out)


def build_all(names: Sequence[str]) -> float:
    """Build every named source not yet built, one ``nvcc`` each, all
    started together; returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in names if not os.path.exists(_target(n))]
    for job in jobs:
        _finish(*job)
    return time.perf_counter() - t0


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` if needed; returns the library path."""
    build_all([name])
    return _target(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of the last build."""
    path = os.path.join(BUILD_DIR, f"{name}.ptxas.txt")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return "".join(line for line in f
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line)
