"""Renderer (port of ``radegs_tpu/renderer.py``; reference
gaussian_renderer/__init__.py:19-195): ``render`` applies the fused Mip
3D-filter getters, runs preprocess + rasterize, and returns the reference's
render() dict; ``integrate`` (and its two halves ``integrate_prepare`` /
``integrate_points``) runs the same preprocess with the inverse ray-space
covariance and the point-opacity integration of ``ops/integrate.py``;
``mark_visible`` is the frustum test. ``prepare`` runs the preprocess
kernel for a view on a card, and its backward kernel where a gradient flows
(``ops/preprocess.py``).
Without an instance budget, ``render`` and ``integrate_prepare`` size their
work buffers from the view's demand by one rule (``_grown``)."""

from __future__ import annotations

import warnings

import torch

from radegs_torch.core.projection import NEAR_PLANE
from radegs_torch.models.gaussian_model import GaussianState
from radegs_torch.ops import integrate as integrate_op
from radegs_torch.ops import preprocess as preprocess_op
from radegs_torch.ops.binning import (
    MAX_PER_TILE_CAP,
    budget_cap,
    default_instance_budget,
    round_budget,
)
from radegs_torch.ops.rasterize import rasterize
from radegs_torch.utils import trace
from radegs_torch.utils.device import resolve_device
from radegs_torch.utils.trace import mark


def _on(device, state: GaussianState, camera):
    dev = resolve_device(device)
    if state.device.type != dev.type:
        raise ValueError(f"the Gaussian state lives on {state.device}, not on {dev}; "
                         "load it with the same device argument")
    return camera if camera.device.type == dev.type else camera.to(state.device)


def _grown(b, budget: int, max_per_tile: int, capacity: int, site: str):
    """The work buffers a binning ``b`` asks for: (instances dropped at the
    budget, at ``max_per_tile``, the budget and ``max_per_tile`` that would
    drop none). The budget grows to the view's demand in ``round_budget``'s
    buckets, up to ``budget_cap(capacity)``; ``max_per_tile`` to the power
    of two above the longest tile, up to ``MAX_PER_TILE_CAP``. The longest
    tile is measured after the budget's cut: a view cut by both may ask for
    more once binned again. The reads are host syncs at ``site``."""
    with trace.sync(site, 2):
        n_ovf, t_ovf = int(b.n_overflow), int(b.tile_overflow)
    with trace.sync(site, (n_ovf > 0) + (t_ovf > 0)):
        need_budget = (round_budget(int(b.n_instances), cap=budget_cap(capacity)) if n_ovf
                       else budget)
        need_tile = (min(max(max_per_tile, 1 << (int(b.max_tile_count) - 1).bit_length()),
                         MAX_PER_TILE_CAP) if t_ovf else max_per_tile)
    return n_ovf, t_ovf, need_budget, need_tile


def _warn_dropped(what: str, n_ovf: int, t_ovf: int, budget: int, max_per_tile: int):
    if n_ovf or t_ovf:
        warnings.warn(f"{what} dropped {n_ovf} instances at the instance budget {budget} "
                      f"and {t_ovf} at max_per_tile {max_per_tile} (their caps)")


def prepare(state: GaussianState, camera, kernel_size: float = 0.0,
            scaling_modifier: float = 1.0, compute_invraycov: bool = False):
    """The preprocess of ``render``: fused filtered scales and opacity,
    inactive slots culled; ``compute_invraycov`` adds the inverse ray-space
    covariance that integration needs. On a card, a view that no gradient
    can flow from (``ops/preprocess.needs_grad`` false) takes the kernel, and
    one that a gradient flows from the kernel pair (``preprocess_train``:
    the kernel forward, its backward kernel); on the CPU the plain version
    runs under autograd."""
    if state.device.type == "cuda":
        if preprocess_op.needs_grad(state):
            return preprocess_op.preprocess_train(state, camera, kernel_size, scaling_modifier,
                                                  compute_invraycov)
        return preprocess_op.preprocess_forward(state, camera, kernel_size, scaling_modifier,
                                                compute_invraycov)
    return preprocess_op.preprocess_torch(state, camera, kernel_size, scaling_modifier,
                                          compute_invraycov)


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

    ``xy_offset``/``xy_abs``: optional (C, 2) zero tensors, side inputs of
    the blend; their gradients are the screen-space mean gradients (pixel
    units) and the GOF absolute gradient statistic — the reference's
    means2D .grad side channel (gaussian_renderer/__init__.py:29-33).

    ``events``: a list that receives (stage, torch.cuda.Event) after the
    preprocess, binning, blend and normalisation stages (CUDA only); given,
    the view is traced (``utils/trace.py``: a ``view`` unit, or a span of
    the step that renders it).

    ``instance_budget``: the binning's cap on (Gaussian, tile) pairs. Given,
    it and ``max_per_tile`` are used as they are (training sizes both with
    its own autotune). None sizes them from the view's demand: the
    capacity's default budget first; while the binning drops instances, the
    view is binned and blended again with the budget and ``max_per_tile``
    grown to what it measured (the budget up to ``budget_cap`` of the
    capacity, ``max_per_tile`` up to ``MAX_PER_TILE_CAP``), and a view that
    still drops instances at the caps raises a warning."""
    with trace.unit("view", events, state.device):
        camera = _on(device, state, camera)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
        mark(events, "start")
        with trace.span("preprocess"):
            prep = prepare(state, camera, kernel_size, scaling_modifier)
            mark(events, "preprocess")
        grow = instance_budget is None
        budget = default_instance_budget(state.capacity) if grow else instance_budget
        while True:
            trace.count("render", "pass")
            out = rasterize(prep, camera, bg, max_per_tile=max_per_tile,
                            instance_budget=budget, tiles_per_block=tiles_per_block,
                            xy_abs=xy_abs, xy_offset=xy_offset, events=events)
            if not grow:
                return out
            n_ovf, t_ovf, need_budget, need_tile = _grown(out["binning"], budget, max_per_tile,
                                                          state.capacity, "render.grow")
            if (need_budget, need_tile) == (budget, max_per_tile):
                break
            budget, max_per_tile = need_budget, need_tile
        _warn_dropped("render", n_ovf, t_ovf, budget, max_per_tile)
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
    ``instance_budget``: given, it and ``max_per_tile`` are used as they are;
    None (or 0) sizes them as ``render`` does: the capacity's default budget first,
    then, while the binning drops instances, the view binned and integrated
    again with the budget and ``max_per_tile`` grown to what it measured, and
    a warning for a view that still drops instances at the caps."""
    camera = _on(device, state, camera)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    prep = prepare(state, camera, kernel_size, compute_invraycov=True)
    grow = not instance_budget
    budget = default_instance_budget(state.capacity) if grow else instance_budget
    while True:
        cache = integrate_op.integrate_view_cache(prep, camera, bg, max_per_tile=max_per_tile,
                                                  instance_budget=budget)
        if not grow:
            return prep, cache
        n_ovf, t_ovf, need_budget, need_tile = _grown(cache["binning"], budget, max_per_tile,
                                                      state.capacity, "integrate.grow")
        if (need_budget, need_tile) == (budget, max_per_tile):
            break
        budget, max_per_tile = need_budget, need_tile
    _warn_dropped("integrate", n_ovf, t_ovf, budget, max_per_tile)
    return prep, cache


@torch.no_grad()
def integrate_points(points3d, prep, cache, camera):
    """Phase B against a prepared cache (``integrate_prepare``): the dict of
    ``integrate`` without ``binning``. ``points3d`` (N, 3) array or tensor."""
    camera = camera if camera.device == prep.table.device else camera.to(prep.table.device)
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
