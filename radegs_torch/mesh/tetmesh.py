"""Marching Tetrahedra (host-side NumPy; the port's own copy of
``radegs_tpu/mesh/tetmesh.py``).

Same contract as the reference's kaolin-derived utils/tetmesh.py:141-190 but
without the chunk/merge machinery (NumPy unique handles the full edge set in
one pass): given per-vertex SDF samples over a tetrahedralization, emit the
crossing EDGES (endpoint pairs + their SDFs + scales) and triangle faces
indexing those edges. Vertex positions are NOT interpolated here — the
extractor refines each crossing edge by binary search re-evaluating the true
SDF (mesh_extract_tetrahedra.py:90-102).

The 16-entry tetrahedron triangle table is the standard published marching-
tetrahedra case table (Doi & Koide 1991; also kaolin, Apache-2.0).
"""

from __future__ import annotations

import numpy as np

TRIANGLE_TABLE = np.array(
    [
        [-1, -1, -1, -1, -1, -1],
        [1, 0, 2, -1, -1, -1],
        [4, 0, 3, -1, -1, -1],
        [1, 4, 2, 1, 3, 4],
        [3, 1, 5, -1, -1, -1],
        [2, 3, 0, 2, 5, 3],
        [1, 4, 0, 1, 5, 4],
        [4, 2, 5, -1, -1, -1],
        [4, 5, 2, -1, -1, -1],
        [4, 1, 0, 4, 5, 1],
        [3, 2, 0, 3, 5, 2],
        [1, 3, 5, -1, -1, -1],
        [4, 1, 2, 4, 3, 1],
        [3, 0, 4, -1, -1, -1],
        [2, 0, 1, -1, -1, -1],
        [-1, -1, -1, -1, -1, -1],
    ],
    dtype=np.int64,
)
NUM_TRIANGLES = np.array([0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int64)
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def marching_tetrahedra(vertices, tets, sdf, scales):
    """vertices (N,3), tets (M,4) int, sdf (N,), scales (N,).

    Returns:
      edge_points (E,2,3): crossing-edge endpoint positions,
      edge_sdf    (E,2):   endpoint SDF values,
      edge_scales (E,2):   endpoint scales,
      faces       (F,3):   triangles indexing crossing edges.
    """
    vertices = np.asarray(vertices, np.float64)
    tets = np.asarray(tets, np.int64)
    sdf = np.asarray(sdf, np.float64)
    scales = np.asarray(scales, np.float64).reshape(-1)

    occ = sdf > 0
    occ4 = occ[tets]  # (M,4)
    inside = occ4.sum(axis=1)
    valid = (inside > 0) & (inside < 4)
    tets_v = tets[valid]
    occ4_v = occ4[valid]
    if tets_v.shape[0] == 0:
        return (np.zeros((0, 2, 3)), np.zeros((0, 2)), np.zeros((0, 2)),
                np.zeros((0, 3), np.int64))

    # all 6 edges per valid tet, canonical (lo, hi) order
    edges = tets_v[:, TET_EDGES].reshape(-1, 2)  # (M*6, 2)
    edges = np.sort(edges, axis=1)
    unique_edges, idx_map = np.unique(edges, axis=0, return_inverse=True)

    crossing = occ[unique_edges].sum(axis=1) == 1
    remap = np.full(unique_edges.shape[0], -1, np.int64)
    remap[crossing] = np.arange(crossing.sum())
    idx_map = remap[idx_map].reshape(-1, 6)

    interp = unique_edges[crossing]  # (E,2) vertex ids
    edge_points = vertices[interp]  # (E,2,3)
    edge_sdf = sdf[interp]  # (E,2)
    edge_scales = scales[interp]  # (E,2)

    # tet case index: bit per inside-vertex
    case = (occ4_v * (1 << np.arange(4))).sum(axis=1)
    ntri = NUM_TRIANGLES[case]
    tt = TRIANGLE_TABLE[case]  # (Mv, 6) local edge slots
    f1 = np.take_along_axis(idx_map[ntri == 1], tt[ntri == 1][:, :3], axis=1)
    f2 = np.take_along_axis(idx_map[ntri == 2], tt[ntri == 2][:, :6], axis=1).reshape(-1, 3)
    faces = np.concatenate([f1.reshape(-1, 3), f2], axis=0)
    return edge_points, edge_sdf, edge_scales, faces
