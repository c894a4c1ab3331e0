"""FP32 peak calibration: dependent chains of a chaotic map.

Port of the TPU kernel ``vpu_peak_flops`` (tools/bench_mfu.py:49-106):
every element of an ``(R, WG)`` float32 array starts eight chains at
``x·(1 − 0.01·k)``, runs ``T`` iterations of ``x ← 3.9·x·(1−x)`` — a
multiply, a subtract and a multiply, 3 FLOPs — and sums the chains in
order; the ``(R, W)`` result holds the last ``W`` columns' sums (the TPU
kernel's column blocks all wrote one tile, the last block last).  The map
is chaotic and cannot be collapsed by a compiler, and it is written without
fused multiply-adds on both sides, so the kernel equals its plain version
bit for bit.

:func:`peak_chains_plain` is the plain torch version, :class:`PeakChains`
the wrapper: CUDA tensors launch ``csrc/peak.cu``, CPU tensors run the
plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["CHAINS", "PeakChains", "peak_chains_plain", "peak_chains_numpy",
           "peak_flops"]

CHAINS = 8
_R_MAP = 3.9


def peak_flops(R: int, WG: int, T: int) -> int:
    """FLOPs of one call: 3 per iteration per chain per element."""
    return 3 * R * WG * CHAINS * T


def peak_chains_plain(x, T: int, W: int):
    """The plain torch version: ``x (R, WG)`` float32 → ``(R, W)``."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    r = torch.full((), _R_MAP, dtype=torch.float32, device=x.device)
    scale = torch.as_tensor(np.asarray([1.0 - 0.01 * k for k in range(CHAINS)],
                                       np.float32), device=x.device)
    xs = x[None] * scale[:, None, None]
    for _ in range(T):
        xs = (r * xs) * (one - xs)
    acc = xs[0]
    for k in range(1, CHAINS):
        acc = acc + xs[k]
    return acc[:, -W:].contiguous()


def peak_chains_numpy(x, T: int, W: int):
    """The same recurrence in numpy float32 (the test oracle)."""
    f32 = np.float32
    xs = [x * f32(1.0 - 0.01 * k) for k in range(CHAINS)]
    for _ in range(T):
        xs = [(f32(_R_MAP) * v) * (f32(1.0) - v) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc[:, -W:]


class PeakChains:
    """``PeakChains()(x, T, W)``; ``PeakChains.launches`` counts kernel
    launches and is incremented only where the CUDA kernel is launched."""

    launches = 0

    def __call__(self, x, T: int, W: int):
        R, WG = x.shape
        if WG % W:
            raise ValueError(f"width {WG} is not a multiple of the tile width {W}")
        if x.device.type == "cpu":
            return peak_chains_plain(x, T, W)
        if x.device.type != "cuda":
            raise ValueError(
                f"the peak kernel runs on cuda or cpu tensors, not {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("x: want a contiguous float32 tensor")
        from .build import load

        lib = load("peak")
        out = torch.empty((R, W), dtype=torch.float32, device=x.device)
        fn = lib.peak_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                R, WG, W, T,
                ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"peak launch failed: CUDA error {rc}")
        PeakChains.launches += 1
        return out
