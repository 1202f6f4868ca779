"""The inputs of a run, made from its seed: the point cloud and its colours,
the view poses and the ground-truth images. The program and the reference
are handed the same inputs.

The point generators are the headline bench's draws (``build_scene`` of
``radegs_torch/scripts/bench.py`` and ``surface_points`` of
``radegs_torch/scripts/synthetic.py``), copied so that the yardstick does
not move with the program: ``cloud`` is N(0, 1.2^2) in 3D, ``surface`` a
sphere |x| = 1.3 with radial noise and a plane patch y = -1.4. The poses
are the wavy orbit of ``scripts/soak_dense.py``'s ``orbit_cameras``.
"""

from __future__ import annotations

import numpy as np
import torch


def cloud_points(n: int, rng):
    """(n, 3) points N(0, 1.2^2): the bench's ``100k`` draws."""
    return (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)


def surface_points(n: int, rng, noise: float = 1.0):
    """(n, 3) points: 2n // 3 on the sphere |x| = 1.3 (radial sigma 0.05),
    the rest on the plane y = -1.4, |x|, |z| <= 3 (sigma 0.02)."""
    n_sphere = (2 * n) // 3
    d = rng.normal(size=(n_sphere, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sphere = d * (1.3 + noise * 0.05 * rng.normal(size=(n_sphere, 1)))
    n_plane = n - n_sphere
    plane = np.stack([rng.uniform(-3, 3, n_plane),
                      np.full(n_plane, -1.4) + noise * 0.02 * rng.normal(size=n_plane),
                      rng.uniform(-3, 3, n_plane)], axis=1)
    return np.concatenate([sphere, plane], 0).astype(np.float32)


GENERATORS = {"cloud": cloud_points, "surface": surface_points}


def points_and_colors(cfg: dict, seed: int):
    """The configuration's point cloud and colours (U(0.1, 0.9)), drawn in
    the bench's order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n = cfg["points"]["n"]
    pts = GENERATORS[cfg["points"]["generator"]](n, rng)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    return pts, cols


def orbit_eyes(n: int, radius: float, elev: float, wave: float, phase: float = 0.0):
    """``n`` eye positions on the wavy orbit around the origin, the i-th at
    angle 2 pi (i + phase) / n."""
    eyes = []
    for i in range(n):
        a = 2 * np.pi * (i + phase) / n
        eyes.append([radius * np.sin(a), elev + wave * np.sin(2 * a), -radius * np.cos(a)])
    return eyes


def view_eyes(cfg: dict):
    """The configuration's training views (its ``views`` orbit poses)."""
    o = cfg["orbit"]
    return orbit_eyes(cfg["views"], o["radius"], o["elev"], o["wave"])


def ground_truth(cfg: dict, seed: int, device):
    """(views, 3, H, W) uniform random images, made on the device from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((cfg["views"], 3, cfg["height"], cfg["width"]), generator=g,
                      device=device)


def views(n_views: int, seed: int):
    """The endless view sequence of training: a stack of seeded permutations
    of the views, popped from the end as ``train()`` draws them."""
    rng = np.random.default_rng([seed, 1])
    while True:
        for v in reversed(rng.permutation(n_views).tolist()):
            yield int(v)


def first_views(n_views: int, n: int, seed: int):
    """The first ``n`` views of ``views``."""
    seq = views(n_views, seed)
    return [next(seq) for _ in range(n)]
