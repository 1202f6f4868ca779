"""The exact reference renderer, slow on purpose (port of
``radegs_tpu/ops/reference.py``): every Gaussian evaluated at every pixel,
without tile binning, with the sequential semantics of
cuda_rasterizer/forward.cu:428-693 and its tile-visibility rule (a pixel
sees only the Gaussians whose screen-space rectangle covers its tile,
rasterizer_impl.cu:70-111). Differentiable by autograd, so
``torch.autograd`` through it is a gradient oracle for the blend's
hand-written backward (the CUDA kernel and its plain version) that shares
no code with either. Memory is O(H W P): small scenes only.
"""

from __future__ import annotations

import math

import torch

from radegs_torch.core.projection import PreprocessOut
from radegs_torch.ops.blend_math import NORMALIZE_EPS, gaussian_alpha, transmittance_weights

TILE = 16  # config.h:16-17


def tile_rect(xy, radius, tiles_x: int, tiles_y: int, tile: int = TILE):
    """Tile-space bounding rectangle [min, max) per Gaussian
    (auxiliary.h:62-72), the exclusive max one past the tile of the last
    covered coordinate, as ``ops.binning`` cuts it."""

    def lo(c, n):
        return torch.clamp(torch.floor((c - radius) / tile), 0, n).to(torch.int32)

    def hi(c, n):
        return torch.clamp(torch.floor((c + radius) / tile) + 1, 0, n).to(torch.int32)

    return (lo(xy[..., 0], tiles_x), lo(xy[..., 1], tiles_y), hi(xy[..., 0], tiles_x),
            hi(xy[..., 1], tiles_y))


def render_reference(prep: PreprocessOut, width: int, height: int, focal_x, focal_y, bg,
                     tile: int = TILE):
    """All output maps of one view, channels first: ``render`` (3,H,W),
    ``alpha``, ``expected_depth``, ``median_depth`` (1,H,W), ``expected_coord``,
    ``median_coord``, ``normal`` (3,H,W), and the accumulators
    ``accum_depth``, ``accum_coord``, ``normal_length``, ``t_final``
    (diff_gaussian_rasterization/__init__.py:101)."""
    P = prep.xy.shape[0]
    H, W = height, width
    dev = prep.xy.device
    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile

    # depth order, invalid Gaussians last (a stable ascending sort)
    order = torch.argsort(torch.where(prep.valid, prep.depth, math.inf), stable=True)
    xy = prep.xy[order]
    conic = prep.conic[order]
    opac = torch.where(prep.valid, prep.opacity, 0.0)[order]
    rgb = prep.rgb[order]
    cplane = prep.camera_plane[order]
    rplane = prep.ray_plane[order]
    normal_g = prep.normal[order]
    ts_g = prep.ts[order]
    vpt = prep.view_point[order]
    radius = torch.where(prep.valid, prep.radius, 0.0)[order]

    px = torch.arange(W, dtype=torch.float32, device=dev)
    py = torch.arange(H, dtype=torch.float32, device=dev)
    pix = torch.stack([px[None, :].expand(H, W).reshape(-1),
                       py[:, None].expand(H, W).reshape(-1)], dim=-1)  # (HW, 2)

    # tile visibility: the pixel's tile inside the Gaussian's rectangle
    rx_min, ry_min, rx_max, ry_max = tile_rect(xy, radius, tiles_x, tiles_y, tile)
    ptx = torch.div(pix[:, 0], tile, rounding_mode="floor").to(torch.int32)
    pty = torch.div(pix[:, 1], tile, rounding_mode="floor").to(torch.int32)
    in_rect = ((ptx[:, None] >= rx_min[None, :]) & (ptx[:, None] < rx_max[None, :])
               & (pty[:, None] >= ry_min[None, :]) & (pty[:, None] < ry_max[None, :]))

    alpha, _ = gaussian_alpha(xy[None], conic[None], opac[None], pix[:, None])  # (HW, P)
    alpha = torch.where(in_rect, alpha, 0.0)
    include, w, t_prefix, t_final = transmittance_weights(alpha, dim=1)

    weight = w.sum(1)  # (HW,)
    color = w @ rgb + t_final[:, None] * bg[None, :]

    # expected depth: t = ts + ray_plane . d (forward.cu:596-604)
    d = xy[None] - pix[:, None]  # (HW, P, 2)
    t_ray = ts_g[None] + d[..., 0] * rplane[None, :, 0] + d[..., 1] * rplane[None, :, 1]
    accum_depth_raw = (w * t_ray).sum(1)

    # expected camera-space coordinate (forward.cu:581-595)
    coord_pt = vpt[None] + cplane[None, :, :, 0] * d[..., 0:1] + cplane[None, :, :, 1] * d[..., 1:2]
    accum_coord = (w[..., None] * coord_pt).sum(1)

    normal_accum = w @ normal_g  # (HW, 3)

    # median: the last included contributor with T > 0.5 (forward.cu:580,591,603)
    med_mask = include & (t_prefix > 0.5)
    idx = torch.arange(P, device=dev)[None, :]
    med_idx = torch.where(med_mask, idx, -1).max(1).values  # (HW,)
    has_med = med_idx >= 0
    med_safe = med_idx.clamp_min(0)
    m_t = torch.gather(t_ray, 1, med_safe[:, None])[:, 0]
    m_t = torch.where(has_med, m_t, 0.0)
    m_coord = torch.gather(coord_pt, 1, med_safe[:, None, None].expand(-1, 1, 3))[:, 0, :]
    m_coord = torch.where(has_med[:, None], m_coord, 0.0)

    any_contrib = include.any(1)

    # distance -> depth (forward.cu:466-467,662-672)
    pixnf_x = (pix[:, 0] - W / 2.0) / focal_x
    pixnf_y = (pix[:, 1] - H / 2.0) / focal_y
    ln = torch.sqrt(pixnf_x**2 + pixnf_y**2 + 1.0)

    # double-where guards: empty pixels give zero gradients, not NaN
    w_safe = torch.where(any_contrib, weight, 1.0)
    inv_w = torch.where(any_contrib, 1.0 / w_safe, 0.0)
    accum_depth = accum_depth_raw / ln
    out_depth = accum_depth * inv_w
    out_mdepth = m_t / ln
    out_coord = accum_coord * inv_w[:, None]

    n2 = torch.square(normal_accum).sum(-1)
    n_len = torch.sqrt(torch.where(any_contrib, n2, 1.0))
    normal_length = torch.where(any_contrib, n_len, 1.0)
    out_normal = torch.where(any_contrib[:, None],
                             normal_accum / torch.clamp_min(n_len, NORMALIZE_EPS)[:, None], 0.0)

    def img(x, c):
        return x.reshape(H, W, c).permute(2, 0, 1)

    return {
        "render": img(color, 3),
        "alpha": img(weight, 1),
        "expected_depth": img(out_depth, 1),
        "median_depth": img(out_mdepth, 1),
        "expected_coord": img(out_coord, 3),
        "median_coord": img(m_coord, 3),
        "normal": img(out_normal, 3),
        "accum_depth": img(accum_depth, 1),
        "accum_coord": img(accum_coord, 3),
        "normal_length": img(normal_length, 1),
        "t_final": img(t_final, 1),
    }
