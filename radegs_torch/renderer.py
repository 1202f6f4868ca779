"""Renderer (port of ``radegs_tpu/renderer.py`` ``render`` and
``mark_visible``; reference gaussian_renderer/__init__.py:19-95): applies the
fused Mip 3D-filter getters, runs preprocess + rasterize, and returns the
reference's render() dict."""

from __future__ import annotations

import torch

from radegs_torch.core.projection import NEAR_PLANE, preprocess_gaussians
from radegs_torch.models.gaussian_model import GaussianState
from radegs_torch.ops.binning import default_instance_budget
from radegs_torch.ops.rasterize import mark, rasterize
from radegs_torch.utils.device import resolve_device


def _on(device, state: GaussianState, camera):
    dev = resolve_device(device)
    if state.device.type != dev.type:
        raise ValueError(f"the Gaussian state lives on {state.device}, not on {dev}; "
                         "load it with the same device argument")
    return camera if camera.device.type == dev.type else camera.to(state.device)


def prepare(state: GaussianState, camera, kernel_size: float = 0.0,
            scaling_modifier: float = 1.0):
    """The preprocess of ``render``: fused filtered scales and opacity,
    inactive slots culled."""
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
    preprocess, binning, blend and normalisation stages (CUDA only)."""
    camera = _on(device, state, camera)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    mark(events, "start")
    prep = prepare(state, camera, kernel_size, scaling_modifier)
    if xy_offset is not None:
        prep = prep.replace(xy=prep.xy + xy_offset)
    mark(events, "preprocess")
    if instance_budget is None:
        instance_budget = default_instance_budget(state.capacity)
    return rasterize(prep, camera, bg, max_per_tile=max_per_tile,
                     instance_budget=instance_budget, tiles_per_block=tiles_per_block,
                     xy_abs=xy_abs, events=events)


def mark_visible(state: GaussianState, camera, device=None):
    """Frustum visibility mask (rasterizer_impl.cu:176-188): view-space
    z > NEAR_PLANE, for active Gaussians."""
    camera = _on(device, state, camera)
    viewmat = camera.world_view
    p_view = state.params.xyz @ viewmat[:3, :3].T + viewmat[:3, 3]
    return (p_view[:, 2] > NEAR_PLANE) & state.active
