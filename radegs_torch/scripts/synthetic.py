"""The synthetic dense surface scene of the quality and soak protocols (port
of the numpy part of ``bench.py``: ``WIDTH``, ``HEIGHT`` and
``_surface_points``).

The scene is a sphere |x| = 1.3 and a plane patch y = -1.4 (|x|, |z| <= 3),
the converged-scene analogue of the JAX bench: splats sit on surfaces and
take their scales from the true 3-NN spacing. With ``noise=0`` the points
lie exactly on the analytic surface whose closed-form distance field
``quality_dense`` scores meshes against.
"""

from __future__ import annotations

import numpy as np

WIDTH, HEIGHT = 1600, 1200


def surface_points(n, rng, noise=1.0):
    """(n, 3) float32 points: 2n // 3 on the sphere (radial noise sigma
    0.05 x ``noise``), the rest on the plane (sigma 0.02 x ``noise``). The
    numpy draws are bench.py's, in its order, so a seeded ``rng`` gives the
    JAX package's points; the noise draws happen at ``noise=0`` too."""
    n_sphere = (2 * n) // 3
    d = rng.normal(size=(n_sphere, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.3 + noise * 0.05 * rng.normal(size=(n_sphere, 1))
    sphere = d * r
    n_plane = n - n_sphere
    plane = np.stack(
        [rng.uniform(-3, 3, n_plane), np.full(n_plane, -1.4)
         + noise * 0.02 * rng.normal(size=n_plane), rng.uniform(-3, 3, n_plane)],
        axis=1,
    )
    return np.concatenate([sphere, plane], 0).astype(np.float32)
