"""ctypes binding for the port's native C++ host library
(``csrc/native_oracle.cpp``).

Port of :mod:`bio_ik_tpu.native`: the double-precision FK oracle
(counterpart of the reference's ``RobotFK_MoveIt`` oracle,
forward_kinematics.h:1468-1503) and the convex support-point query.  The
source is the port's own copy of the JAX package's; it is built with
``g++ -O3 -shared -fPIC -std=c++17`` on first use into
``build/native/libnative_oracle-<hash>.so`` at the root of the checkout
(the hash is of the source and the flags, so an edited source is rebuilt).
Without a toolchain the import still succeeds and :func:`available`
returns False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

__all__ = ["available", "oracle_fk", "support_point", "library_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "native_oracle.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """The library's path: ``build/native/libnative_oracle-<hash>.so``."""
    digest = hashlib.sha1(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libnative_oracle-{digest.hexdigest()[:12]}.so")


def _build(so: str) -> bool:
    """g++ into a temporary file beside ``so``, then an atomic rename: two
    processes building at once each leave a whole library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.bioik_fk_batch.argtypes = [
        ctypes.c_int64, c_i64p, c_i64p, c_f64p, c_f64p, c_f64p, c_i64p,
        ctypes.c_int64, c_i64p, c_f64p, c_f64p,
        ctypes.c_int64, c_f64p,
        ctypes.c_int64, c_i64p,
        c_f64p, c_f64p,
    ]
    lib.bioik_fk_batch.restype = None
    lib.bioik_support_point.argtypes = [ctypes.c_int64, c_f64p, c_f64p]
    lib.bioik_support_point.restype = ctypes.c_int64
    lib.bioik_native_abi_version.argtypes = []
    lib.bioik_native_abi_version.restype = ctypes.c_int
    if lib.bioik_native_abi_version() != _ABI_VERSION:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def oracle_fk(model, qs: np.ndarray, tip_links: Sequence[str]) -> tuple:
    """Double-precision batched FK oracle: ``qs (B, Vfull)`` →
    ``(pos (B, T, 3), quat (B, T, 4))``, numpy float64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++, or it failed)")
    qs = np.ascontiguousarray(np.atleast_2d(qs), dtype=np.float64)
    if qs.shape[-1] != model.nvars:
        raise ValueError(f"qs has {qs.shape[-1]} variables, the model {model.nvars}")
    B = qs.shape[0]
    tips = np.asarray([model.link_index[t] for t in tip_links], dtype=np.int64)
    T = len(tips)
    out_pos = np.empty((B, T, 3), dtype=np.float64)
    out_quat = np.empty((B, T, 4), dtype=np.float64)
    lib.bioik_fk_batch(
        model.nlinks,
        np.ascontiguousarray(model.parent, np.int64),
        np.ascontiguousarray(model.jtype, np.int64),
        np.ascontiguousarray(model.origin_pos, np.float64),
        np.ascontiguousarray(model.origin_quat, np.float64),
        np.ascontiguousarray(model.axis, np.float64),
        np.ascontiguousarray(model.vstart, np.int64),
        model.nvars,
        np.ascontiguousarray(model.mimic_src, np.int64),
        np.ascontiguousarray(model.mimic_factor, np.float64),
        np.ascontiguousarray(model.mimic_offset, np.float64),
        B,
        qs,
        T,
        tips,
        out_pos,
        out_quat,
    )
    return out_pos, out_quat


def support_point(points: np.ndarray, direction: np.ndarray) -> int:
    """Index of the convex-hull support point along ``direction``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++, or it failed)")
    pts = np.ascontiguousarray(points, np.float64).reshape(-1, 3)
    d = np.ascontiguousarray(direction, np.float64).reshape(3)
    return int(lib.bioik_support_point(len(pts), pts, d))
