"""Carrying state across between the JAX package and the port.

What the two sides share is the robot model (built from the same URDF on
both), the ``make_data`` tree of goal parameters, the ``(rows, N)`` solver
state and constants, and the one set of learned weights: the ``neural`` and
``neural2`` modes' MLP, which each side trains at construction.  These
helpers convert such a tree — dicts, lists, tuples and named tuples of
arrays — between numpy (anything ``np.asarray`` accepts, e.g. arrays taken
from the JAX package) and the port's tensors, keeping structure and key
names identical so tests feed both sides the same numbers, and turn the
JAX package's MLP parameters into the port's module.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["tree_map", "tree_from_numpy", "tree_to_numpy", "mlp_params_from_jax"]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list/tuple/named-tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:      # key words: torch keeps them in int64
        a = a.astype(np.int64)
    if not a.flags.writeable:     # e.g. arrays viewed from the JAX package
        a = a.copy()
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def tree_from_numpy(tree, device=None):
    """numpy leaves → tensors on ``device`` (uint32 → int64): the card unless
    the caller asks for the CPU, as every entry point
    (:func:`~bio_ik_tpu_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x, dev), tree)


def tree_to_numpy(tree):
    """tensor leaves → numpy arrays on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if torch.is_tensor(x) else np.asarray(x), tree)


def mlp_params_from_jax(params, device=None):
    """The JAX package's MLP parameters ``[(w (d_in, d_out), b (d_out,)),
    …]`` (as numpy arrays) → the port's :class:`~bio_ik_tpu_torch.solvers.
    neural.MLP` with the same weights, on ``device`` (the card unless the
    caller asks for the CPU)."""
    from .solvers.neural import MLP

    ws = [(np.asarray(w), np.asarray(b)) for w, b in params]
    dev = resolve_device(device)
    net = MLP([ws[0][0].shape[0]] + [w.shape[1] for w, _ in ws],
              torch.as_tensor(ws[0][0]).dtype, dev, torch.Generator(device=dev))
    with torch.no_grad():
        for lin, (w, b) in zip(net.layers, ws):
            lin.weight.copy_(torch.as_tensor(w.T.copy(), device=dev))
            lin.bias.copy_(torch.as_tensor(b.copy(), device=dev))
    return net
