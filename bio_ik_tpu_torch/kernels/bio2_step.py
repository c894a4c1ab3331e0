"""Static shape/config of the fused bio2 kernels.

Port of the parameter block of :mod:`bio_ik_tpu.kernels.bio2_step`.  The
species-tier kernel itself (``make_species_kernel``) is not ported yet
(ROADMAP.md, port queue item 3).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["SpeciesParams", "SEC_ROWS", "_P"]

_P = 2  # parents kept per species (reference: population_size=2, ik_evolution_2.cpp:137)

# packed per-variable secondary-fitness rows, in the reference's order
# (engine._secondary_rows); used once secondary goals are ported
SEC_ROWS = ("alpha", "beta", "gamma", "delta", "tbar", "mid", "hspan",
            "seed")


class SpeciesParams(NamedTuple):
    """Static shape/config of the fused kernel."""

    V: int            # active variables
    K: int            # pose-goal instances
    C: int = 16       # children per generation (reference :138)
    gens: int = 8     # generations (reference :349-351, memetic variant)
    mem_iters: int = 8  # memetic iterations (reference :453)
    memetic: str = "q"  # 'q' quadratic | 'l' linear | '' none
    h: float = 1e-3   # memetic probe length
    quat_slices: tuple = ()  # floating-joint quat gene blocks (species tier)
