"""DTU chamfer evaluation (DTUeval-python protocol, dtu_eval/eval.py).

The port's own copy of ``radegs_tpu/eval/dtu.py``, numpy + scipy
(cKDTree) as there: mesh surface sampling at the downsample density,
radius-based downsampling, ObsMask + ground-plane filtering, bidirectional
NN distances with a max-dist cutoff, and the colored error point clouds.
The same numpy calls in the same order (``radius_downsample``'s seeded
permutation and its greedy Python loop included), so both packages give
the same bits. ``evaluate_dtu(stats=)`` records the host seconds of its
stages.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
from scipy.spatial import cKDTree

from radegs_torch.utils import ply as plyio


def sample_mesh_surface(vertices, triangles, thresh):
    """Sample triangle interiors to ~thresh spacing (dtu_eval/eval.py:10-19,
    44-72); returns vertices + interior samples."""
    tri = vertices[triangles]  # (T,3,3)
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    ok = area2 > 0
    v1, v2, tri, l1, l2, area2 = v1[ok], v2[ok], tri[ok], l1[ok], l2[ok], area2[ok]
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    chunks = [vertices]
    # group triangles by (n1, n2) so each group samples vectorized
    keys = n1 * 100_000 + n2
    order = np.argsort(keys)
    sorted_keys = keys[order]
    boundaries = np.nonzero(np.diff(sorted_keys))[0] + 1
    for grp in np.split(order, boundaries):
        a, b = int(n1[grp[0]]), int(n2[grp[0]])
        if a == 0 and b == 0:
            continue
        c = np.mgrid[: a + 1, : b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        k = c.transpose(1, 2, 0).reshape(-1, 2)
        k = k[k.sum(axis=-1) < 1]  # (m,2) barycentric
        if len(k) == 0:
            continue
        pts = (
            tri[grp][:, None, 0]
            + k[None, :, :1] * v1[grp][:, None]
            + k[None, :, 1:] * v2[grp][:, None]
        ).reshape(-1, 3)
        chunks.append(pts)
    return np.concatenate(chunks, axis=0)


def radius_downsample(points, thresh, seed=0):
    """Greedy radius downsampling (dtu_eval/eval.py:85-94)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(points.shape[0])
    pts = points[perm]
    tree = cKDTree(pts)
    mask = np.ones(pts.shape[0], bool)
    for curr, idxs in enumerate(tree.query_ball_point(pts, thresh, workers=-1)):
        if mask[curr]:
            mask[idxs] = False
            mask[curr] = True
    return pts[mask]


def evaluate_dtu(mesh_path, scan, dataset_dir, out_dir=None,
                 downsample_density=0.2, patch_size=60.0, max_dist=20.0,
                 visualize_threshold=10.0, stats=None):
    """Full DTUeval (dtu_eval/eval.py:27-167). Requires the official DTU
    ObsMask/ and Points/stl/ reference data under dataset_dir.
    Returns {"mean_d2s", "mean_s2d", "overall"}. ``stats``: a dict that
    receives the host seconds of the surface sampling (``sample_s``), the
    radius downsample (``downsample_s``) and the two KD-tree queries
    (``kd_s``), and the point counts before and after the downsample
    (``n_samples``, ``n_down``)."""
    from scipy.io import loadmat

    stats = {} if stats is None else stats
    thresh = downsample_density
    verts, faces = plyio.read_mesh(mesh_path)
    t0 = time.perf_counter()
    data_pcd = sample_mesh_surface(verts.astype(np.float64), faces, thresh)
    t1 = time.perf_counter()
    data_down = radius_downsample(data_pcd, thresh)
    stats.update(sample_s=t1 - t0, downsample_s=time.perf_counter() - t1,
                 n_samples=len(data_pcd), n_down=len(data_down))

    obs = loadmat(os.path.join(dataset_dir, "ObsMask", f"ObsMask{scan}_10.mat"))
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = (
        (data_down >= BB[:1] - patch_size) & (data_down < BB[1:] + patch_size * 2)
    ).sum(axis=-1) == 3
    data_in = data_down[inbound]
    grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_in = ((grid >= 0) & (grid < np.asarray(ObsMask.shape)[None])).sum(-1) == 3
    gi = grid[grid_in]
    in_obs = ObsMask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
    data_in_obs = data_in[grid_in][in_obs]

    stl, _, _ = plyio.read_point_cloud(
        os.path.join(dataset_dir, "Points", "stl", f"stl{scan:03}_total.ply")
    )
    stl = stl.astype(np.float64)

    t0 = time.perf_counter()
    d2s, _ = cKDTree(stl).query(data_in_obs, workers=-1)
    t_kd = time.perf_counter() - t0
    mean_d2s = float(d2s[d2s < max_dist].mean())

    plane = loadmat(os.path.join(dataset_dir, "ObsMask", f"Plane{scan}.mat"))["P"]
    above = (np.concatenate([stl, np.ones_like(stl[:, :1])], -1) @ plane.reshape(4)) > 0
    stl_above = stl[above]
    t0 = time.perf_counter()
    s2d, _ = cKDTree(data_in).query(stl_above, workers=-1)
    stats["kd_s"] = t_kd + time.perf_counter() - t0
    mean_s2d = float(s2d[s2d < max_dist].mean())

    result = {
        "mean_d2s": mean_d2s,
        "mean_s2d": mean_s2d,
        "overall": (mean_d2s + mean_s2d) / 2,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # colored error clouds (dtu_eval/eval.py:138-154)
        vis = visualize_threshold
        col = np.tile([[0.0, 0.0, 1.0]], (data_down.shape[0], 1))
        a = np.clip(d2s, None, vis)[:, None] / vis
        sel = np.nonzero(inbound)[0][grid_in][in_obs]
        col[sel] = [1, 0, 0] * a + [1, 1, 1] * (1 - a)
        col[sel[d2s >= max_dist]] = [0, 1, 0]
        plyio.write_point_cloud(os.path.join(out_dir, f"vis_{scan:03}_d2s.ply"),
                                data_down.astype(np.float32), col)
        col2 = np.tile([[0.0, 0.0, 1.0]], (stl.shape[0], 1))
        a2 = np.clip(s2d, None, vis)[:, None] / vis
        sel2 = np.nonzero(above)[0]
        col2[sel2] = [1, 0, 0] * a2 + [1, 1, 1] * (1 - a2)
        col2[sel2[s2d >= max_dist]] = [0, 1, 0]
        plyio.write_point_cloud(os.path.join(out_dir, f"vis_{scan:03}_s2d.ply"),
                                stl.astype(np.float32), col2)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(result, f, indent=True)
    return result


def chamfer_distance(points_a, points_b, max_dist=None):
    """Plain bidirectional chamfer (utility for tests / quick checks)."""
    d_ab, _ = cKDTree(points_b).query(points_a, workers=-1)
    d_ba, _ = cKDTree(points_a).query(points_b, workers=-1)
    if max_dist is not None:
        d_ab = d_ab[d_ab < max_dist]
        d_ba = d_ba[d_ba < max_dist]
    return (d_ab.mean() + d_ba.mean()) / 2
