"""Multi-process bring-up helpers: ``torch.distributed`` and device meshes.

Port of :mod:`bio_ik_tpu.parallel.distributed`.  The reference has no
distributed backend beyond pthreads (SURVEY §5.8; reference:
src/ik_parallel.h:43-87 is a single-process barrier pool).  Here each card
is one process: :func:`initialize_distributed` joins the process group
(NCCL between cards; gloo when the caller asks for the CPU), and
:func:`make_pod_mesh` builds the named ``DeviceMesh`` that the island and
scenario sharding of :mod:`bio_ik_tpu_torch.parallel.islands` consume.

The island solve all-gathers a handful of values per chunk (the winner
reduction and elite migration), and scenario batching gathers only the
results, so collective bandwidth does not matter.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["initialize_distributed", "make_pod_mesh", "local_batch_slice",
           "DEFAULT_TIMEOUT"]

# a bootstrap or collective that waits longer than this fails
DEFAULT_TIMEOUT = timedelta(seconds=120)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the default process group, one process per card.

    ``coordinator_address`` (``host:port``, or a URL with its scheme) is
    rank 0's TCP store, and then ``num_processes`` and ``process_id`` are
    required; without it the launcher's environment is read (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them).  On the card (the default) the backend is NCCL
    and the process takes card ``LOCAL_RANK`` (else its rank) modulo the
    cards it sees; ``device="cpu"`` takes gloo.  ``timeout`` bounds the
    bootstrap and every collective.
    """
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if init_method.startswith("tcp://") and (num_processes is None or process_id is None):
        raise ValueError("a coordinator address needs num_processes and process_id")
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout)


def make_pod_mesh(axes: Sequence[str] = ("data",),
                  shape: Optional[Sequence[int]] = None,
                  device="cuda"):
    """Global mesh over every process of the default group (one card each).

    Default: a 1-D mesh (scenario batching or island racing).  With two
    axes (e.g. ``("data", "islands")``) and a ``shape``, scenario shards
    split across the first axis and each scenario's islands across the
    second.  Returns a ``torch.distributed.device_mesh.DeviceMesh`` with
    the axes as its dimension names; :func:`initialize_distributed` comes
    first.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape is required for multi-axis meshes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} processes")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def local_batch_slice(global_batch: int, axis_size: int,
                      process_index: Optional[int] = None) -> slice:
    """Rows of a scenario batch evenly sharded over ``axis_size`` mesh
    slots that this process owns: ``global_batch / processes`` rows from
    ``process_index`` (default: this process's rank) on, as the JAX
    package computes them."""
    if global_batch % axis_size:
        raise ValueError(f"batch {global_batch} not divisible by {axis_size}")
    rank, size = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                  else (0, 1))
    pi = rank if process_index is None else process_index
    per = global_batch // size
    return slice(pi * per, (pi + 1) * per)
