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

Besides the files of ``csrc/``, a kernel instance can be a *generated*
source (:func:`generate`): a few ``#define`` lines and the ``#include`` of
a ``csrc/*.cuh`` header, written to ``build/kernels/gen/<name>.cu`` and
compiled with ``-I csrc``.  The megastep and species wrappers generate the
instance of a shape that no file of ``csrc/`` holds on its first use;
:func:`load`, :func:`build_all`, :func:`ptxas_report` and
:data:`BUILD_SECONDS` take a generated name as they take a file's.
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

__all__ = ["build", "build_all", "load", "generate", "source_path", "ptxas_report",
           "ptxas_table", "ptxas_rows", "BUILD_DIR", "BUILD_SECONDS", "CSRC", "GEN_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
GEN_DIR = os.path.join(BUILD_DIR, "gen")
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
# generated sources of this process: name -> (text, extra nvcc flags)
_generated: Dict[str, tuple] = {}


def generate(name: str, text: str, flags: Sequence[str] = ()) -> str:
    """Register the generated source ``name`` (its text and its nvcc flags
    beyond :data:`NVCC_FLAGS`); :func:`load` and :func:`build_all` then
    take the name.  The file is written when it is built.  Returns the
    name."""
    if name in EXTRA_FLAGS or os.path.exists(os.path.join(CSRC, f"{name}.cu")):
        raise ValueError(f"{name} names a source of csrc/")
    _generated[name] = (text, list(flags))
    return name


def source_path(name: str) -> str:
    """The ``.cu`` file of a source: ``csrc/<name>.cu`` or, for a
    generated name, ``build/kernels/gen/<name>.cu``."""
    if name in _generated:
        return os.path.join(GEN_DIR, f"{name}.cu")
    return os.path.join(CSRC, f"{name}.cu")


def _extra(name: str):
    return _generated[name][1] if name in _generated else EXTRA_FLAGS.get(name, [])


def _flags(name: str):
    """nvcc's flags for the source (a generated one finds its header with
    ``-I csrc``)."""
    return NVCC_FLAGS + ["-I", CSRC] * (name in _generated) + _extra(name)


def _text(name: str) -> bytes:
    if name in _generated:
        return _generated[name][0].encode()
    with open(source_path(name), "rb") as f:
        return f.read()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> str:
    """The library path, named by a hash of the source (a generated
    source's text), the shared headers (``csrc/*.cuh``) and the flags
    (``-I csrc`` left out: the checkout's path is no part of the code)."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS + _extra(name)).encode())
    digest.update(_text(name))
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _write_generated(name: str) -> str:
    """Write a generated source's file (through a temporary file and
    ``os.replace``, so that processes building one shape do not collide)."""
    path = source_path(name)
    os.makedirs(GEN_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(_generated[name][0])
    os.replace(tmp, path)
    return path


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _target(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = _write_generated(name) if name in _generated else source_path(name)
    cmd = [_nvcc(), *_flags(name), "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str, log: str) -> None:
    with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source_path(name)}:\n{log[-8000:]}")
    os.replace(tmp, out)


# wall seconds of each source's last nvcc run in this process
BUILD_SECONDS: Dict[str, float] = {}


# sources being built by some thread of this process: name -> its Event
_building: Dict[str, threading.Event] = {}
_building_lock = threading.Lock()


def build_all(names: Sequence[str]) -> float:
    """Build every named source (a file of ``csrc/`` or a generated name)
    not yet built, one ``nvcc`` each, all started together; returns the
    wall seconds (each source's own in :data:`BUILD_SECONDS`).  A source
    that another thread is building is waited for, not built twice, so a
    build started in the background serves the first use of its kernels."""
    t0 = time.perf_counter()
    with _building_lock:
        mine = [n for n in dict.fromkeys(names)
                if n not in _building and not os.path.exists(_target(n))]
        theirs = [_building[n] for n in dict.fromkeys(names) if n in _building]
        for n in mine:
            _building[n] = threading.Event()
    try:
        jobs = [(n, *_start(n)) for n in mine]
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
    finally:
        with _building_lock:
            for n in mine:
                _building.pop(n).set()
    for event in theirs:
        event.wait()
    missing = [n for n in names if not os.path.exists(_target(n))]
    if missing:
        raise RuntimeError(f"the build of {missing} failed in another thread")
    return time.perf_counter() - t0


def build(name: str) -> str:
    """Build the source ``name`` if needed; returns the library path."""
    build_all([name])
    return _target(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the source ``name``, built on first use."""
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
