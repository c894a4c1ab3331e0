#!/usr/bin/env python
"""Where a wide-layout megastep lane spends its cycles, by phase, on the card.

Builds each wide source of ``tools/megastep_ab.py``'s ladders again, into
the git-ignored ``build/megastep_phases/``, with a ``clock64()`` probe in
place of the header's empty ``WIDE_PHASE`` markers (``csrc/megastep_wide.cuh``):
the first thread of each lane of the first 64 blocks adds the cycles since
its last marker to one of seven counters — the exact FK and linearization
at parent 0, the children's genes, their evaluation and selection, the new
parents, the memetic search, the exact FK and fitness of the new parent 0,
the species bookkeeping — and ``prof_read`` returns and clears them.
``--cap N`` builds them from a copy of ``csrc/`` whose ``WIDE_MIN_BLOCKS``
holds the register budget to N resident blocks an SM instead of the
header's.  The builds are a measuring aid: nothing on a solve path loads
them.

At the first launch of each wide ladder of ``megastep_ab.LADDERS``
(in-kernel Philox, inputs from ``kernels/checks.megastep_inputs``) and at
every width the instance builds, prints one JSON line: the launch's ms
(CUDA events, one launch after one warm-up), the resident warps per SM, the
cycles a lane-step took for one lane (the probe's sum over lanes and
steps), and each phase's share.

Usage (on the card)::

    python -m bio_ik_tpu_torch.tools.megastep_phases [--cap 6]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from bio_ik_tpu_torch import RobotModel, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels import build
from bio_ik_tpu_torch.kernels.bio2_megastep import _BLOCK
from bio_ik_tpu_torch.kernels.checks import megastep_inputs
from bio_ik_tpu_torch.tools.megastep_ab import LADDERS, _instance, cuda_ms, ladder

PHASES = ("fk_lin", "genes", "eval_select", "parents", "memetic", "fk_fit", "book")

# the probe: a counter per phase, the last marker's clock per thread (of
# the first 64 blocks of at most 1 024 threads)
_PROBE = """#pragma once
#include <cuda_runtime.h>
__device__ unsigned long long g_phase[8];
__device__ long long g_last[64 * 1024];
#define WIDE_PHASE(i) do { if (blockIdx.x < 64 && X.j == 0) { \\
  const long long t_ = clock64(), s_ = blockIdx.x * blockDim.x + threadIdx.x; \\
  if ((i) >= 0) atomicAdd(&g_phase[(i) < 0 ? 0 : (i)], \\
                          (unsigned long long)(t_ - g_last[s_])); \\
  g_last[s_] = t_; } } while (0)
extern "C" int prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""


def build_probed(sources, cap):
    """Build each source with the probe (and the register cap) into
    ``build/megastep_phases/``, all at once; returns ``{source: CDLL}``."""
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "megastep_phases",
                       f"cap{cap}" if cap else "header")
    os.makedirs(out, exist_ok=True)
    probe = os.path.join(out, "probe.cuh")
    with open(probe, "w") as f:
        f.write(_PROBE)
    csrc = build.CSRC
    if cap:
        csrc = os.path.join(out, "csrc")
        shutil.copytree(build.CSRC, csrc, dirs_exist_ok=True)
        path = os.path.join(csrc, "megastep_wide.cuh")
        with open(path) as f:
            text, n = re.subn(r"constexpr int WIDE_MIN_BLOCKS = \d+;",
                              f"constexpr int WIDE_MIN_BLOCKS = {cap};", f.read())
        if n != 1:
            raise RuntimeError("megastep_phases: WIDE_MIN_BLOCKS is not one constant")
        with open(path, "w") as f:
            f.write(text)
    procs = {}
    for src in sources:
        cu = (build._write_generated(src) if src in build._generated
              else os.path.join(csrc, f"{src}.cu"))
        procs[src] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, *build._extra(src),
             "-include", probe, "-o", os.path.join(out, f"lib{src}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for src, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the probed {src}:\n{log[-4000:]}")
        libs[src] = ctypes.CDLL(os.path.join(out, f"lib{src}.so"))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=int, default=None,
                    help="resident blocks per SM the register budget is held to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("megastep_phases: needs the card")
    dev = torch.device("cuda")
    cases = []
    for label, urdf, tips, kinds, terms, B, phases, fractions in LADDERS:
        N, steps = ladder(B, phases, fractions)[0]
        mega, sp = _instance(urdf, tips, kinds, terms, steps, dev)
        if mega.instance.wide:
            cases.append((label, urdf, tips, kinds, terms, N, steps, mega, sp))
    libs = build_probed(sorted({c[7].source for c in cases}), args.cap)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, urdf, tips, kinds, terms, N, steps, mega, sp in cases:
        lib = libs[mega.source]
        mega._lib = lambda n, lib=lib: lib          # launch the probed copy
        cpu = RobotModel.from_urdf_file(asset_path(urdf), device="cpu")
        state, consts, _ = megastep_inputs(cpu, list(tips), sp, steps, N, with_noise=False,
                                           sec_terms=terms, inst_kind=list(kinds))
        state, consts = tree_from_numpy(state, dev), tree_from_numpy(consts, dev)
        salt = torch.arange(N, dtype=torch.int32, device=dev)[None] // 2
        buf = (ctypes.c_ulonglong * 8)()
        for w in mega.groups:
            blocks = mega.resident_blocks(lib, dev, w)
            if blocks < 1:
                continue
            run = lambda: mega(state, consts, seed=99, salt=salt, group=w)  # noqa: E731
            ms = cuda_ms(run, 1)
            lib.prof_read(buf)                     # clears the counters
            run()
            torch.cuda.synchronize()
            lib.prof_read(buf)
            total = sum(buf[:7])
            lanes = min(64, -(-N * w // _BLOCK)) * _BLOCK // w     # the probed lanes
            print(json.dumps({
                "path": label, "instance": [sp.V, sp.K, mega.T], "sec_terms": list(terms),
                "lanes": N, "n_steps": steps, "W": w, "cap": args.cap, "ms": ms,
                "warps_per_sm": blocks // sms * _BLOCK // 32,
                "kcycles_per_lane_step": total / lanes / steps / 1e3,
                "share": {PHASES[i]: buf[i] / total for i in range(7)}, "gpu": gpu}),
                flush=True)
        del state, consts
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
