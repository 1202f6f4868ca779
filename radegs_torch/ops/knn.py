"""K-nearest-neighbour mean squared distance for the initial Gaussian
scales (port of ``radegs_tpu/ops/knn.py``; the reference calls simple-knn's
``distCUDA2`` once, scene/gaussian_model.py:315).

The JAX package's algorithm is kept, so ``create_from_points`` gives the
JAX scales: an exact search for P <= 2048; above that the union of a 27-cell
spatial-hash search (exact in dense regions) and a Morton-window pass
(sparse tails), deduplicated, then the k smallest. An exact ``cdist`` would
be a different result.
"""

from __future__ import annotations

import torch


def _expand_bits(v):
    """Spread 10 bits over 30 (Morton interleave helper)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points):
    """(P, 3) float -> (P,) Morton codes on a 1024^3 grid over the bbox."""
    lo = points.min(0).values
    hi = points.max(0).values
    span = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((points - lo) / span * 1023.0, 0, 1023).to(torch.int64)
    return _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)


def _smallest(d2, k: int):
    return torch.topk(d2, k, dim=1, largest=False).values


def _window_knn_pass(points, k: int, window: int):
    """k smallest squared distances per point among its +-``window``
    neighbours in Morton order."""
    P = points.shape[0]
    order = torch.sort(morton_codes(points), stable=True).indices
    sorted_pts = points[order]
    W = window
    pad_lo = torch.flip(sorted_pts[:W], dims=[0]) + 1e6  # far sentinels
    pad_hi = torch.flip(sorted_pts[-W:], dims=[0]) + 1e6
    padded = torch.cat([pad_lo, sorted_pts, pad_hi], dim=0)
    idx = (torch.arange(P, device=points.device)[:, None]
           + torch.arange(2 * W + 1, device=points.device)[None, :])  # window incl. self
    d2 = sum((padded[:, a][idx] - sorted_pts[:, a][:, None]) ** 2 for a in range(3))
    d2[:, W] = torch.inf  # drop self
    out = torch.empty((P, k), dtype=points.dtype, device=points.device)
    out[order] = _smallest(d2, k)
    return out


def _grid_knn_candidates(points, k: int, cap: int = 16):
    """k smallest squared distances from a 27-cell spatial-hash search, cells
    sized to ~1 point, up to ``cap`` points per neighbour cell."""
    P = points.shape[0]
    dev = points.device
    lo = points.min(0).values
    hi = points.max(0).values
    vol = torch.prod(torch.clamp_min(hi - lo, 1e-9))
    cell = (vol / P) ** (1.0 / 3.0)
    res = torch.clamp(torch.clamp_min(((hi - lo) / cell).to(torch.int32) + 1, 1), max=1024)
    cell_sz = torch.clamp_min((hi - lo) / res.to(torch.float32), 1e-9)
    ijk = torch.minimum(torch.clamp_min(((points - lo) / cell_sz).to(torch.int32), 0), res - 1)
    res64 = res.to(torch.int64)

    def cid(v):
        v = v.to(torch.int64)
        return (v[..., 2] * res64[1] + v[..., 1]) * res64[0] + v[..., 0]

    cids = cid(ijk)
    order = torch.sort(cids, stable=True).indices
    sp = points[order]
    sc = cids[order]
    r = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    nijk = ijk[:, None, :] + offs[None, :, :]
    valid = ((nijk >= 0) & (nijk < res)).all(-1)
    ncid = cid(torch.minimum(torch.clamp_min(nijk, 0), res - 1))
    start = torch.searchsorted(sc, ncid)
    end = torch.searchsorted(sc, ncid, right=True)
    cnt = torch.clamp_max(end - start, cap)
    slots = torch.arange(cap, device=dev)
    idx = torch.clamp(start[:, :, None] + slots, 0, P - 1).reshape(P, 27 * cap)
    ok = ((slots < cnt[:, :, None]) & valid[:, :, None]).reshape(P, 27 * cap)
    d2 = sum((sp[:, a][idx] - points[:, a][:, None]) ** 2 for a in range(3))
    d2 = torch.where(ok, d2, torch.inf)
    d2 = torch.where(d2 <= 1e-24, torch.inf, d2)  # drop self
    return _smallest(d2, k)


def mean_dist2_knn(points, k: int = 3, window: int = 32):
    """Mean squared distance to the k nearest neighbours, per point:
    (P, 3) -> (P,), used as ``scales = log(sqrt(clamp(dist2, 1e-7)))``.
    Above 2048 points, an over-approximation of the true mean (the
    candidates are a subset of the neighbours), as the upstream box search."""
    P = points.shape[0]
    if P <= 2048:
        return _exact_mean_dist2(points, k)
    merged = torch.sort(torch.cat([_grid_knn_candidates(points, k),
                                   _window_knn_pass(points, k, window)], dim=1), dim=1).values
    # the same neighbour found by both passes repeats with an identical
    # distance: mask repeats so it is not counted twice
    dup = merged[:, 1:] == merged[:, :-1]
    merged[:, 1:] = torch.where(dup, torch.inf, merged[:, 1:])
    return _smallest(merged, k).mean(-1)


def _exact_mean_dist2(points, k: int = 3):
    d2 = sum((points[:, a][:, None] - points[:, a][None, :]) ** 2 for a in range(3))
    d2.fill_diagonal_(torch.inf)
    return _smallest(d2, k).mean(-1)
