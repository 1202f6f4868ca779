"""Renderer (port of ``radegs_tpu/renderer.py``; reference
gaussian_renderer/__init__.py:19-195): ``render`` applies the fused Mip
3D-filter getters, runs preprocess + rasterize, and returns the reference's
render() dict; ``integrate`` (and its two halves ``integrate_prepare`` /
``integrate_points``) runs the same preprocess with the inverse ray-space
covariance and the point-opacity integration of ``ops/integrate.py``;
``mark_visible`` is the frustum test. Without an instance budget, ``render``
and ``integrate_prepare`` size their work buffers from the view's demand."""

from __future__ import annotations

import warnings

import torch

from radegs_torch.core.projection import NEAR_PLANE, preprocess_gaussians
from radegs_torch.models.gaussian_model import GaussianState
from radegs_torch.ops import integrate as integrate_op
from radegs_torch.ops.binning import MAX_PER_TILE_CAP, default_instance_budget, round_budget
from radegs_torch.ops.rasterize import mark, rasterize
from radegs_torch.utils.device import resolve_device


def _on(device, state: GaussianState, camera):
    dev = resolve_device(device)
    if state.device.type != dev.type:
        raise ValueError(f"the Gaussian state lives on {state.device}, not on {dev}; "
                         "load it with the same device argument")
    return camera if camera.device.type == dev.type else camera.to(state.device)


def prepare(state: GaussianState, camera, kernel_size: float = 0.0,
            scaling_modifier: float = 1.0, compute_invraycov: bool = False):
    """The preprocess of ``render``: fused filtered scales and opacity,
    inactive slots culled; ``compute_invraycov`` adds the inverse ray-space
    covariance that integration needs."""
    scales, opacity = state.get_fused_scaling_opacity()
    opacity = torch.where(state.active[:, None], opacity, 0.0)
    prep = preprocess_gaussians(
        state.params.xyz,
        scales,
        state.get_rotation(),
        opacity,
        state.get_features(),
        sh_degree=state.max_sh_degree,
        camera=camera,
        kernel_size=kernel_size,
        scale_modifier=scaling_modifier,
        active_sh_degree=state.active_sh_degree,
        compute_invraycov=compute_invraycov,
    )
    return prep.replace(valid=prep.valid & state.active)


def render(
    state: GaussianState,
    camera,
    bg,
    kernel_size: float = 0.0,
    scaling_modifier: float = 1.0,
    max_per_tile: int = 512,
    instance_budget: int | None = None,
    tiles_per_block: int = 2,
    device=None,
    events: list | None = None,
    xy_offset=None,
    xy_abs=None,
):
    """Render a view on ``device`` (default ``cuda``; the state must already
    live there). Always uses the fused filtered scales and opacity
    (gaussian_renderer/__init__.py:63) and SH colour at the state's active
    degree. ``bg`` is a (3,) background colour. Differentiable w.r.t. the
    state's parameters.

    ``xy_offset``/``xy_abs``: optional (C, 2) zero tensors; their gradients
    are the screen-space mean gradients (pixel units) and the GOF absolute
    gradient statistic — the reference's means2D .grad side channel
    (gaussian_renderer/__init__.py:29-33).

    ``events``: a list that receives (stage, torch.cuda.Event) after the
    preprocess, binning, blend and normalisation stages (CUDA only).

    ``instance_budget``: the binning's cap on (Gaussian, tile) pairs. Given,
    it and ``max_per_tile`` are used as they are (training sizes both with
    its own autotune). None sizes them from the view's demand: the
    capacity's default budget first; while the binning drops instances, the
    view is binned and blended again with the budget and ``max_per_tile``
    grown to what it measured (``max_per_tile`` up to ``MAX_PER_TILE_CAP``),
    and a view that still drops instances at the caps raises a warning."""
    camera = _on(device, state, camera)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    mark(events, "start")
    prep = prepare(state, camera, kernel_size, scaling_modifier)
    if xy_offset is not None:
        prep = prep.replace(xy=prep.xy + xy_offset)
    mark(events, "preprocess")
    grow = instance_budget is None
    budget = default_instance_budget(state.capacity) if grow else instance_budget
    while True:
        out = rasterize(prep, camera, bg, max_per_tile=max_per_tile, instance_budget=budget,
                        tiles_per_block=tiles_per_block, xy_abs=xy_abs, events=events)
        if not grow:
            return out
        b = out["binning"]
        n_ovf, t_ovf = int(b.n_overflow), int(b.tile_overflow)
        # the per-tile demand is measured after the budget's cut: one more
        # pass when both cut
        need_budget = round_budget(int(b.n_instances)) if n_ovf else budget
        need_tile = (min(max(max_per_tile, 1 << (int(b.max_tile_count) - 1).bit_length()),
                         MAX_PER_TILE_CAP) if t_ovf else max_per_tile)
        if (need_budget, need_tile) == (budget, max_per_tile):
            break
        budget, max_per_tile = need_budget, need_tile
    if n_ovf or t_ovf:
        warnings.warn(f"render dropped {n_ovf} instances at the instance budget {budget} and "
                      f"{t_ovf} at max_per_tile {max_per_tile} (their caps)")
    return out


def mark_visible(state: GaussianState, camera, device=None):
    """Frustum visibility mask (rasterizer_impl.cu:176-188): view-space
    z > NEAR_PLANE, for active Gaussians."""
    camera = _on(device, state, camera)
    viewmat = camera.world_view
    p_view = state.params.xyz @ viewmat[:3, :3].T + viewmat[:3, 3]
    return (p_view[:, 2] > NEAR_PLANE) & state.active


@torch.no_grad()
def integrate_prepare(state: GaussianState, camera, bg, kernel_size: float = 0.0,
                      max_per_tile: int = 1024, instance_budget: int | None = None,
                      device=None):
    """The points-independent half of ``integrate`` on ``device`` (default
    ``cuda``): preprocess with the inverse ray-space covariance, radius-only
    binning, the phase-A image and the median plane. Returns (prep, cache)
    for ``integrate_points``, reusable across point sets (the tetra
    extractor's binary search evaluates 1 + 8 point sets per view).
    Without an ``instance_budget`` the capacity's default is used, and grown
    to the measured demand where it drops instances."""
    camera = _on(device, state, camera)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    prep = prepare(state, camera, kernel_size, compute_invraycov=True)
    budget = instance_budget or default_instance_budget(state.capacity)
    cache = integrate_op.integrate_view_cache(prep, camera, bg, max_per_tile=max_per_tile,
                                              instance_budget=budget)
    if instance_budget is None and int(cache["binning"].n_overflow):
        cache = integrate_op.integrate_view_cache(
            prep, camera, bg, max_per_tile=max_per_tile,
            instance_budget=round_budget(int(cache["binning"].n_instances)))
    return prep, cache


@torch.no_grad()
def integrate_points(points3d, prep, cache, camera):
    """Phase B against a prepared cache (``integrate_prepare``): the dict of
    ``integrate`` without ``binning``. ``points3d`` (N, 3) array or tensor."""
    camera = camera if camera.device == prep.xy.device else camera.to(prep.xy.device)
    return integrate_op.integrate_points_cached(points3d, prep, cache, camera)


@torch.no_grad()
def integrate(points3d, state: GaussianState, camera, bg, kernel_size: float = 0.0,
              max_per_tile: int = 1024, instance_budget: int | None = None, device=None):
    """Point-opacity integration on ``device`` (default ``cuda``; the state
    must already live there) (gaussian_renderer/__init__.py:98-195): the
    preprocess of ``render`` plus the inverse ray-space covariance. Returns
    render (9, H, W), alpha_integrated (N,), color_integrated (N, 3),
    point_coordinate (N, 2), point_sdf (N,), point_valid (N,) and binning."""
    prep, cache = integrate_prepare(state, camera, bg, kernel_size, max_per_tile,
                                    instance_budget, device)
    out = integrate_points(points3d, prep, cache, camera)
    out["binning"] = cache["binning"]
    return out
