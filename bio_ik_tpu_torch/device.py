"""Device resolution for the port's entry points.

Every entry point (``RobotModel``, ``IKSolver``, ``AdaptiveBatchSolver``,
``make_fk``) runs on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA where there is none raises —
there is no silent CPU fallback.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "asset_path"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions on the CPU")
    return dev


def asset_path(name: str) -> str:
    """Path to a bundled URDF/STL asset (pr2_arm, ur5, snake, ...).

    The assets live with the JAX reference package, ``bio_ik_tpu/assets``;
    the port reads them in place by path and never imports that package.
    """
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), "bio_ik_tpu", "assets", name)
