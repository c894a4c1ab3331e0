"""Profiling and tracing utilities.

Port of :mod:`bio_ik_tpu.profiling` (reference: the embedded sampling
profiler, src/utils.h:134-317).  The profiler of record is
``torch.profiler``: :func:`trace` records the enclosed block (the card's
kernels through CUPTI where there is a card) and writes a Chrome trace,
viewable in Perfetto; :func:`annotate` opens a named range (the FNPROFILER
analog) that shows up inside such a trace.

Quick phase timing without a trace viewer: :class:`PhaseTimer` measures the
wall-clock time of phases, synchronizing the card at each phase's end so
its queued work counts to that phase, and prints a ranking (reference:
utils.h:286-303).  :class:`SolveStats` holds the per-call metrics that
``SolverConfig(counter=True)`` records.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

__all__ = ["trace", "annotate", "PhaseTimer", "SolveStats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` (host operators, and
    the card's kernels when CUDA is available) and write it to
    ``log_dir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range visible in profiler traces (FNPROFILER analog)."""
    return torch.profiler.record_function(name)


class SolveStats:
    """Rolling serving metrics of an :class:`bio_ik_tpu_torch.api.IKSolver`
    (reference: the per-query ``counter`` log, ik_parallel.h:107, 263-266,
    widened to batches): queries, successes, solver steps and wall time
    accumulate per call; :meth:`summary` returns them as a dict.  Enabled
    by ``SolverConfig.counter``; recording reads the success and fitness
    tensors on the host, so it is opt-in."""

    def __init__(self):
        self.queries = 0
        self.successes = 0
        self.batches = 0
        self.steps = 0
        self.wall_s = 0.0
        self.fitness_sum = 0.0

    def record(self, result, wall_s: float, steps: int) -> None:
        ok = np.atleast_1d(result.success.detach().cpu().numpy())
        fit = np.atleast_1d(result.fitness.detach().cpu().numpy())
        self.queries += int(ok.size)
        self.successes += int(ok.sum())
        self.batches += 1
        self.steps += int(steps)
        self.wall_s += float(wall_s)
        self.fitness_sum += float(fit.sum())

    def summary(self) -> Dict[str, float]:
        q = max(self.queries, 1)
        return {
            "queries": self.queries,
            "batches": self.batches,
            "success_rate": self.successes / q,
            "mean_fitness": self.fitness_sum / q,
            "mean_steps_per_call": self.steps / max(self.batches, 1),
            "wall_s": self.wall_s,
            "queries_per_sec": self.queries / max(self.wall_s, 1e-12),
        }

    def report(self) -> str:
        s = self.summary()
        return (f"{s['queries']} queries in {s['batches']} calls: "
                f"{100 * s['success_rate']:.1f} % success, "
                f"{s['queries_per_sec']:.0f} q/s, "
                f"mean fitness {s['mean_fitness']:.3e}")


class PhaseTimer:
    """Wall-clock phase accumulator with a reference-style ranking report
    (reference: Profiler report, utils.h:286-303)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # the card's queued work belongs to the phase that queued it
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = ["p    time      calls  phase"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{t / total:5.3f} {t:8.4f}s {self.counts[name]:6d}  {name}")
        return "\n".join(lines)
