"""Minimal STL mesh loading for collision geometry.

The reference derives TouchGoal contact surfaces from the robot's full
collision model including convex meshes, walking cached hull edges for
the support-vertex query (reference: src/goal_types.cpp:45-228, esp.
:183-208, via FCL's convex geometry).  Here mesh collision elements are
loaded from STL (the dominant URDF collision format), reduced to their
convex-hull vertex set, and handed to the same point-cloud support
machinery as the primitive shapes — a min/max over hull vertices IS the
exact convex support for plane queries, so no edge-walk is needed on
the batched path (the scalar edge-walking oracle lives in ``native/``).

Both STL flavors are handled: binary (80-byte header + uint32 count +
50-byte triangles) and ASCII ("solid ... facet normal ... vertex x y z").
Only vertices are used; normals and connectivity are ignored.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["load_stl", "convex_hull_vertices"]


def _is_binary_stl(data: bytes) -> bool:
    # binary files may also start with b"solid"; trust the triangle-count
    # size check over the prefix
    if len(data) < 84:
        return False
    (ntri,) = struct.unpack_from("<I", data, 80)
    return len(data) == 84 + 50 * ntri


def load_stl(path: str) -> np.ndarray:
    """Load an STL file → deduplicated ``(N, 3)`` float64 vertex array."""
    with open(path, "rb") as f:
        data = f.read()
    if _is_binary_stl(data):
        (ntri,) = struct.unpack_from("<I", data, 80)
        # each 50-byte record: normal (3f), 3 vertices (9f), 2-byte attr
        tri = np.frombuffer(data, dtype=np.uint8,
                            count=50 * ntri, offset=84)
        tri = tri.reshape(ntri, 50)[:, :48].copy().view("<f4").reshape(
            ntri, 4, 3)
        verts = tri[:, 1:4, :].reshape(-1, 3).astype(np.float64)
    else:
        text = data.decode("ascii", errors="replace")
        rows = []
        for line in text.splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3])])
        if not rows:
            raise ValueError(f"no vertices found in STL file {path!r}")
        verts = np.asarray(rows, dtype=np.float64)
    return np.unique(verts, axis=0)


def convex_hull_vertices(points: np.ndarray) -> np.ndarray:
    """Vertices of the convex hull of ``points`` — the exact support set
    (degenerate/coplanar inputs fall back to the full point set)."""
    if len(points) < 4:
        return points
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(points)
        return points[hull.vertices]
    except Exception:
        return points
