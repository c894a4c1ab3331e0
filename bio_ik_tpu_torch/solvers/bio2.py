"""bio2 family helpers.

Port of the static set-up of :class:`bio_ik_tpu.solvers.bio2.Bio2Solver`
that the fused engine reads.  The unfused ``Bio2Solver`` itself is ROADMAP.md
port queue item 5; it will build on :func:`quat_gene_slices`.
"""

from __future__ import annotations

from typing import List, Sequence

from ..robot.urdf import FLOATING

__all__ = ["quat_gene_slices"]


def quat_gene_slices(model, active_vars: Sequence[int]) -> List[int]:
    """Start slots, in the active-gene vector, of the quaternion blocks of
    active floating joints — renormalized after every mutation (reference:
    ik_evolution_2.cpp:117-126, :320-324).  A block counts only when its
    four variables are active and contiguous in the active set, the rule
    of ``Bio2Solver.__init__`` (bio_ik_tpu/solvers/bio2.py:69-81)."""
    active = list(active_vars)
    out = []
    for li in range(model.nlinks):
        if model.jtype[li] == FLOATING and model.vstart[li] >= 0:
            qv = int(model.vstart[li]) + 3
            if qv in active:
                s = active.index(qv)
                if active[s:s + 4] == [qv, qv + 1, qv + 2, qv + 3]:
                    out.append(s)
    return out
