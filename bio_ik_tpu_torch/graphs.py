"""Replaying a function's kernels from a CUDA graph.

The island path's solvers (bio1's and gd's steps, optlib's evaluations,
bio2's L-BFGS phase, the neural modes' training) evaluate one function —
FK, the fitness and, for a gradient, its backward — many times on tensors
of one shape, and eager PyTorch launches each of its hundreds to thousands
of small kernels from the host every time.  :class:`Replay` runs the first
calls of such a function eagerly, then captures one call into a CUDA graph
over static copies of its arguments and replays that graph for every later
call: the same kernels in the same order on the same shapes, so the results
are bitwise the eager call's, at one host launch a call.  On CPU tensors it
calls the function.

Everything a call reads that changes between calls must be one of its
arguments (tensors, or dict/list/tuple/named-tuple trees of them): the graph
reads what it closes over at the addresses it had at capture, so a closure
may only hold what lives as long as the :class:`Replay` and never changes
(a model's constants, a network's parameters updated in place).  The
function must not touch the host: no copy from host memory (``torch.tensor``
of a list, ``torch.as_tensor`` of an array), no ``.item()``, no
data-dependent shapes — a capture refuses them.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

__all__ = ["Replay", "const"]

_WARMUP = 2   # eager calls on a side stream before a capture (allocator, autograd)


_CONSTS: Dict[Tuple, torch.Tensor] = {}


def const(values: tuple, dtype, device) -> torch.Tensor:
    """The constant tensor ``values`` on ``device``, copied from the host
    once: a call captured into a CUDA graph may not copy from the host.
    Shared by every caller: never written in place."""
    key = (values, dtype, device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTS[key]


def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves``; → its structure."""
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, kids = spec
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in kids}
    vals = [_unflatten(s, leaves) for s in kids]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def _leaf_key(x):
    return (tuple(x.shape), x.dtype) if torch.is_tensor(x) else ("const", x)


def _capture(fn: Callable, args) -> tuple:
    """``(graph, fn(*args))``: the call captured into a new CUDA graph, with
    Python's cyclic garbage collector off meanwhile.  A solver holds its
    graphs in reference cycles (its replayed functions close over it), so a
    collection can free a dead solver's graphs at any allocation, and
    destroying a graph while a stream captures invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = fn(*args)
    finally:
        if enabled:
            gc.enable()
    return graph, out


class Replay:
    """``fn(*args) → tensor or tuple of tensors``, replayed from one CUDA
    graph per argument structure, shape and dtype on CUDA tensors; the first
    ``_WARMUP`` calls of each run eagerly, the next one captures the graph.
    Non-tensor leaves (None, numbers) are part of the key and baked into its
    graph.  Called directly on CPU tensors.  Returns fresh tensors: the
    graph's outputs are copied out."""

    replays = 0   # graph replays of every instance, for measurements to read

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: Dict[Tuple, tuple] = {}
        self._eager: Dict[Tuple, int] = {}
        self.counts: Dict[Tuple, int] = {}   # replays of each graph, for measurements

    def __call__(self, *args):
        leaves = []
        spec = _flatten(args, leaves)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        if not tensors[0].is_cuda:
            return self.fn(*args)
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        if key not in self._graphs:
            n = self._eager.get(key, 0)
            if n < _WARMUP:
                # the first calls run for real on a side stream: they warm
                # up the allocator and autograd before the capture
                self._eager[key] = n + 1
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    out = self.fn(*args)
                torch.cuda.current_stream().wait_stream(side)
                return out
            static = [x.detach().clone() if torch.is_tensor(x) else x for x in leaves]
            graph, out = _capture(self.fn, _unflatten(spec, iter(static)))
            self._graphs[key] = (graph, [x for x in static if torch.is_tensor(x)], out)
            del self._eager[key]
        graph, static, out = self._graphs[key]
        for s, a in zip(static, tensors):
            s.copy_(a)
        graph.replay()
        Replay.replays += 1
        self.counts[key] = self.counts.get(key, 0) + 1
        if isinstance(out, tuple):
            return tuple(o.clone() for o in out)
        return out.clone()

    def graphs(self):
        """``(graph, replays)`` of each captured graph: a measurement replays
        the graph (on its static inputs, the last call's) to read its
        kernels."""
        return [(g, self.counts.get(k, 0)) for k, (g, _, _) in self._graphs.items()]
