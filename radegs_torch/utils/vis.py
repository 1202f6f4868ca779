"""Visualisation helpers (port of ``radegs_tpu/utils/vis.py``; reference
utils/vis_utils.py): depth colormaps, normal-map colours and a coloured
point-cloud dump, in numpy."""

from __future__ import annotations

import numpy as np

# perceptually-uniform-ish 'turbo'-style anchor colors
_TURBO = np.array(
    [
        [48, 18, 59], [62, 73, 137], [67, 125, 191], [52, 173, 200],
        [36, 208, 168], [62, 231, 112], [134, 240, 55], [202, 228, 34],
        [246, 192, 35], [253, 137, 38], [233, 80, 28], [191, 33, 15],
        [122, 4, 3],
    ],
    np.float32,
) / 255.0


def apply_colormap(x, cmap=_TURBO):
    """(H,W) values in [0,1] -> (H,W,3) float colors."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    pos = x * (len(cmap) - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, len(cmap) - 1)
    t = (pos - lo)[..., None]
    return cmap[lo] * (1 - t) + cmap[hi] * t


def apply_depth_colormap(depth, accumulation=None, near_plane=None, far_plane=None):
    """utils/vis_utils.py:20-48: normalized turbo depth, optionally faded by
    accumulation (alpha)."""
    depth = np.asarray(depth, np.float32)
    near = near_plane if near_plane is not None else float(np.min(depth))
    far = far_plane if far_plane is not None else float(np.max(depth))
    x = (depth - near) / max(far - near, 1e-10)
    img = apply_colormap(x)
    if accumulation is not None:
        a = np.asarray(accumulation, np.float32)[..., None]
        img = img * a + (1.0 - a)
    return img


def normal_to_rgb(normal_chw):
    """(3,H,W) unit normals -> (H,W,3) colors in [0,1]."""
    n = np.asarray(normal_chw, np.float32).transpose(1, 2, 0)
    return np.clip(n * 0.5 + 0.5, 0.0, 1.0)


def save_points_ply(path, points, colors=None):
    """Colored point-cloud dump (utils/vis_utils.py:50-69)."""
    from radegs_torch.utils.ply import write_point_cloud

    write_point_cloud(path, np.asarray(points, np.float32), colors)
