"""The differentiable rasterizer (port of ``radegs_tpu/ops/rasterize.py``
``rasterize``): tile binning on detached inputs, the blend as a
``torch.autograd.Function`` (forward ``blend_forward``, backward
``blend_backward``: the CUDA kernels on the card, their plain versions on
the CPU), and the output normalisation of rasterize.py:602-641 (weight
normalisation, distance -> depth through ``ln`` from the pixel rows,
background compositing, normal normalisation) in plain PyTorch, so autograd
supplies the corrections backward.cu:737-779 derives by hand.

As in the JAX package's custom VJP, the Function's boundary is drawn around
the raw accumulators only; ``med_pos`` is not differentiable, and the
gradient of the dummy input ``xy_abs`` is the GOF densification side
channel (rasterize.py:457-497).

Band mode (``render_width``, ``render_height``, ``band_row0``) renders one
horizontal band of the image, as the multi-rank step does
(``parallel/step.py``): binning, the blend and ``untile`` use the band's
size; ``ln`` uses global rows and the full camera geometry.
"""

from __future__ import annotations

import torch

from radegs_torch.core.projection import PreprocessOut
from radegs_torch.ops.binning import (
    TILE,
    TileBinning,
    bin_gaussians,
    default_instance_budget,
    tile_grid,
)
from radegs_torch.ops.blend import (
    blend_backward,
    blend_forward_packed,
    tile_pixel_coords,
    unpack_raw,
)
from radegs_torch.utils import trace
from radegs_torch.utils.trace import mark

NORMALIZE_EPS = 1e-12


def untile(x, width: int, height: int):
    """(C, T, 256) -> (C, H, W), cropping the tile padding."""
    tiles_x, tiles_y = tile_grid(width, height)
    C = x.shape[0]
    img = x.reshape(C, tiles_y, tiles_x, TILE, TILE).permute(0, 1, 3, 2, 4)
    return img.reshape(C, tiles_y * TILE, tiles_x * TILE)[:, :height, :width]


def blend_inputs(prep: PreprocessOut):
    """The per-Gaussian blend inputs; culled Gaussians get opacity 0."""
    return (prep.xy, prep.conic, torch.where(prep.valid, prep.opacity, 0.0), prep.rgb,
            prep.view_point, prep.camera_plane, prep.ray_plane, prep.normal, prep.ts)


def bin_prep(prep: PreprocessOut, width: int, height: int, instance_budget: int,
             max_per_tile: int, need_tile_gauss: bool) -> TileBinning:
    """``bin_gaussians`` over a preprocess result, with the exact work cuts,
    on detached inputs (the JAX package's stop_gradients, rasterize.py:567-583)."""
    return bin_gaussians(
        prep.xy.detach(), prep.radius.detach(), prep.depth.detach(), prep.valid,
        width, height, instance_budget=instance_budget, max_per_tile=max_per_tile,
        conic=prep.conic.detach(),
        opacity=torch.where(prep.valid, prep.opacity.detach(), 0.0),
        need_tile_gauss=need_tile_gauss,
    )


class BlendFunction(torch.autograd.Function):
    """The blend between the nine per-Gaussian inputs (plus the dummy
    ``xy_abs``) and the packed raw outputs (T, 17, 256) and ``med_pos``.
    ``events`` (a list or None) is carried to the backward, which marks
    "tail_backward" on entry (autograd has then run the backward of
    everything after the blend) and passes it to ``blend_backward``."""

    @staticmethod
    def forward(ctx, binning, width, height, tiles_per_block, ndc_size, events, xy, xy_abs,
                conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts):
        inputs = (xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts)
        out, med_pos = blend_forward_packed(binning, inputs, width, height, tiles_per_block,
                                            events=events)
        ctx.binning = binning
        ctx.events = events
        ctx.geometry = (width, height, tiles_per_block, ndc_size)
        ctx.save_for_backward(*inputs, out, med_pos)
        ctx.mark_non_differentiable(med_pos)
        return out, med_pos

    @staticmethod
    def backward(ctx, g_out, _g_med_pos):
        # absent cotangents arrive as zeros (materialised by autograd)
        mark(ctx.events, "tail_backward")
        *inputs, out, med_pos = ctx.saved_tensors
        width, height, tiles_per_block, ndc_size = ctx.geometry
        with trace.span("blend_bwd"):
            grads = blend_backward(ctx.binning, tuple(inputs), unpack_raw(out, med_pos),
                                   unpack_raw(g_out, None), width, height, tiles_per_block,
                                   ndc_size=ndc_size, events=ctx.events)
        return (None, None, None, None, None, None, grads["xy"], grads["xy_abs"],
                grads["conic"], grads["opacity"], grads["rgb"], grads["view_point"],
                grads["camera_plane"], grads["ray_plane"], grads["normal"], grads["ts"])


def normalize(raw, camera, bg, width: int | None = None, height: int | None = None,
              band_row0: int = 0):
    """Raw accumulators -> the render() images (rasterize.py:602-641) of a
    ``width`` x ``height`` render (default the camera's) whose first row is
    global row ``band_row0``."""
    W, H = width or camera.width, height or camera.height
    pix_x, pix_y = tile_pixel_coords(W, H, raw["weight"].device)
    # ln uses the global image geometry (W/2-centred, forward.cu:466), also
    # for a band
    pnx = (pix_x - camera.width / 2.0) / camera.focal_x
    pny = (pix_y + band_row0 - camera.height / 2.0) / camera.focal_y
    ln = torch.sqrt(pnx * pnx + pny * pny + 1.0)  # (T, 256)

    weight = raw["weight"]
    any_contrib = weight > 0.0
    # double-where guards: an empty pixel yields zeros, never NaN
    w_safe = torch.where(any_contrib, weight, 1.0)
    inv_w = torch.where(any_contrib, 1.0 / w_safe, 0.0)

    color = raw["color_raw"] + raw["t_final"][None] * bg[:, None, None]
    out_depth = raw["dist_raw"] / ln * inv_w
    out_mdepth = raw["med_t"] / ln
    out_coord = raw["coord_raw"] * inv_w[None]
    n2 = torch.sum(torch.square(raw["normal_raw"]), dim=0)
    n_len = torch.sqrt(torch.where(any_contrib, n2, 1.0))
    out_normal = torch.where(any_contrib[None],
                             raw["normal_raw"] / torch.clamp_min(n_len, NORMALIZE_EPS)[None],
                             0.0)
    return {
        "render": untile(color, W, H),
        "mask": untile(weight[None], W, H),
        "expected_depth": untile(out_depth[None], W, H),
        "median_depth": untile(out_mdepth[None], W, H),
        "expected_coord": untile(out_coord, W, H),
        "median_coord": untile(raw["med_coord"], W, H),
        "normal": untile(out_normal, W, H),
    }


def rasterize(
    prep: PreprocessOut,
    camera,
    bg,
    binning: TileBinning | None = None,
    max_per_tile: int = 512,
    instance_budget: int | None = None,
    tiles_per_block: int = 2,
    xy_abs=None,
    events: list | None = None,
    render_width: int | None = None,
    render_height: int | None = None,
    band_row0: int = 0,
):
    """Binning + blend + output normalisation. Returns the render() dict of
    gaussian_renderer/__init__.py:85-95 (channels-first images) plus
    ``radii``, ``visibility_filter`` and the ``binning`` diagnostics.

    ``tiles_per_block``: tiles per CUDA block of the blend kernels (1 or 2).
    ``xy_abs``: optional (P, 2) zeros; its gradient is the GOF absolute
    screen-gradient densification statistic.
    ``events``: a list that receives (stage, torch.cuda.Event) after the
    binning, blend and normalisation stages (CUDA only), for stage timing,
    and the blend wrappers' marks: forward and backward (``BlendFunction``).
    ``render_width`` / ``render_height`` / ``band_row0``: render only the
    band of global rows ``band_row0 ..`` (rasterize.py:529-539); ``prep.xy``
    must already be shifted to band-local rows (y - band_row0). The camera
    keeps the full image: ``ln`` uses global rows, and the GOF statistic's
    NDC scale the full image size."""
    W, H = render_width or camera.width, render_height or camera.height
    on_cpu = prep.xy.device.type == "cpu"

    if binning is None:
        if instance_budget is None:
            instance_budget = default_instance_budget(prep.xy.shape[0])
        binning = bin_prep(prep, W, H, instance_budget, max_per_tile,
                           need_tile_gauss=on_cpu)
    mark(events, "binning")
    if xy_abs is None:
        xy_abs = torch.zeros_like(prep.xy)
    xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts = \
        blend_inputs(prep)
    out, med_pos = BlendFunction.apply(binning, W, H, tiles_per_block,
                                       (camera.width, camera.height), events, xy, xy_abs,
                                       conic, opacity, rgb, view_point, camera_plane,
                                       ray_plane, normal, ts)
    raw = unpack_raw(out, med_pos)
    mark(events, "blend")
    with trace.span("normalize"):
        out = normalize(raw, camera, bg, W, H, band_row0)
        mark(events, "normalize")
    out.update(radii=prep.radius, visibility_filter=prep.valid & (prep.radius > 0),
               binning=binning)
    return out
