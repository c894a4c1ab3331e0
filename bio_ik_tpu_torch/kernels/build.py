"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout
(the hash is of the source and the shared ``csrc/*.cuh`` headers, so an
edited source is rebuilt), for
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
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

__all__ = ["build", "build_all", "load", "ptxas_report", "ptxas_table",
           "ptxas_rows", "BUILD_DIR", "BUILD_SECONDS", "CSRC"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-source flags: the species kernel keeps the plain version's rounding
# (no FMA contraction; see the note at the top of csrc/species.cu); the
# wide and high-DOF megasteps' kernels compile in parallel (one thread each
# on an H100's host: the wide source's seven in 43 s instead of 156 s, the
# same registers, stack and spill)
EXTRA_FLAGS = {"species": ["-fmad=false"], "megastep_wide": ["--split-compile=0"],
               "megastep_high": ["--split-compile=0"]}

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
    """The library path, named by a hash of the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha1(" ".join(_flags(name)).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _target(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str, log: str) -> None:
    with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log[-8000:]}")
    os.replace(tmp, out)


# wall seconds of each source's last nvcc run in this process
BUILD_SECONDS: Dict[str, float] = {}


def build_all(names: Sequence[str]) -> float:
    """Build every named source not yet built, one ``nvcc`` each, all
    started together; returns the wall seconds (each source's own in
    :data:`BUILD_SECONDS`)."""
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in names if not os.path.exists(_target(n))]
    logs = {}

    def drain(name, proc):
        logs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=drain, args=job[:2]) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for job in jobs:
        _finish(*job, logs[job[0]])
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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_NUM = {"stack": re.compile(r"(\d+) bytes stack frame"),
              "spill_stores": re.compile(r"(\d+) bytes spill stores"),
              "spill_loads": re.compile(r"(\d+) bytes spill loads"),
              "registers": re.compile(r"Used (\d+) registers")}


def ptxas_table(name: str):
    """One row per kernel of the last build's ``-Xptxas -v`` report
    (:func:`ptxas_rows`)."""
    return ptxas_rows(ptxas_report(name))


def ptxas_rows(log: str):
    """One row per kernel of an ``-Xptxas -v`` log: ``{"entry",
    "registers", "stack", "spill_stores", "spill_loads"}``, the entry
    demangled with the toolkit's ``cu++filt`` where it is found."""
    rows = []
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            rows.append({"entry": m.group(1)})
            continue
        for key, rx in _PTXAS_NUM.items():
            m = rx.search(line)
            if m and rows:
                rows[-1][key] = int(m.group(1))
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r["entry"] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout
        for r, dm in zip(rows, out.splitlines()):
            r["entry"] = dm.strip()
    return rows
