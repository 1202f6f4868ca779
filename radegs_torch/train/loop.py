"""The training loop (port of ``radegs_tpu/train/loop.py``; reference
train.py:61-214): one ``train_step`` (render -> loss -> backward through the
blend kernel and autograd through preprocess -> Adam -> densification
statistics), and densify / prune / opacity reset on the reference's
schedule. PyTorch runs eagerly, so plain Python takes the place of the JAX
package's ``jax.jit``; nothing is wrapped in ``torch.compile``.

Decoupled appearance (``models/appearance.py``) trains beside the Gaussians
with the same explicit Adam arithmetic, dense over the whole network and
embedding table, on the loop's own step count. Not ported yet (it raises
``NotImplementedError``): the multi-card mesh path (``parallel/``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from radegs_torch.core.geometry import depth_double_to_normal, point_double_to_normal
from radegs_torch.models import gaussian_model as gm
from radegs_torch.models.appearance import (
    AppearanceNetwork,
    appearance_transform,
    init_appearance,
)
from radegs_torch.ops.binning import (
    BUDGET_SEG,
    MAX_INSTANCE_BUDGET,
    MAX_PER_TILE_CAP,
    default_instance_budget,
    round_budget,
)
from radegs_torch.ops.rasterize import mark
from radegs_torch.ops.ssim import l1_loss, ssim
from radegs_torch.renderer import render
from radegs_torch.train.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    replace as replace_cfg,
)
from radegs_torch.train.optim import BETA1, BETA2, EPS, GroupLRs, adam_step, expon_lr
from radegs_torch.utils.device import resolve_device

MESH_TODO = ("multi-card training (parallel/) is not ported yet: it is the last slice of "
             "the port (ROADMAP.md queue A, parallel/ on torch.distributed)")


@dataclass(frozen=True)
class TrainState:
    """The Gaussians (with their Adam moments), the appearance parameters
    and their Adam moments (``{"net": {name: tensor}, "embeddings": tensor}``
    each, or None without decoupled appearance), and the iteration."""

    gaussians: gm.GaussianState
    iteration: int = 0
    app_params: dict | None = None
    app_m: dict | None = None
    app_v: dict | None = None

    def replace(self, **kw) -> "TrainState":
        return replace(self, **kw)


def map_app(fn, *trees):
    """``fn`` over the tensors of appearance trees of one structure."""
    return {"net": {k: fn(*(t["net"][k] for t in trees)) for k in trees[0]["net"]},
            "embeddings": fn(*(t["embeddings"] for t in trees))}


def init_train_state(gaussians: gm.GaussianState, use_appearance: bool = False,
                     height: int = 0, width: int = 0,
                     generator: torch.Generator | None = None) -> TrainState:
    """A fresh state; with ``use_appearance`` the appearance network and
    embeddings are drawn from ``generator`` (default: seeded 0 on the
    Gaussians' device) and their moments start at zero."""
    if not use_appearance:
        return TrainState(gaussians=gaussians)
    if generator is None:
        generator = torch.Generator(device=gaussians.device).manual_seed(0)
    _, app = init_appearance(generator, height, width)
    return TrainState(gaussians=gaussians, app_params=app,
                      app_m=map_app(torch.zeros_like, app), app_v=map_app(torch.zeros_like, app))


def instance_budget(pcfg: PipelineConfig, capacity: int) -> int:
    """The explicit budget, or the capacity-derived default (capped)."""
    return pcfg.instance_budget or min(
        default_instance_budget(capacity, pcfg.instance_multiplier), MAX_INSTANCE_BUDGET)


def compute_loss(gaussians: gm.GaussianState, app_params, xy_offset, xy_abs, camera,
                 gt_image, bg, iteration: int, mcfg: ModelConfig, ocfg: OptimizationConfig,
                 pcfg: PipelineConfig, view_idx: int = 0, events: list | None = None):
    """The loss of train.py:124-162: L1 + D-SSIM, plus the depth-normal
    consistency term from ``regularization_from_iter`` on. With decoupled
    appearance the L1 term compares the transformed centre crop with the gt
    crop; SSIM and PSNR stay on the raw image. Returns (loss, aux)."""
    out = render(gaussians, camera, bg, kernel_size=mcfg.kernel_size,
                 max_per_tile=pcfg.max_per_tile,
                 instance_budget=instance_budget(pcfg, gaussians.capacity),
                 tiles_per_block=pcfg.tiles_per_block, device=gaussians.device,
                 xy_offset=xy_offset, xy_abs=xy_abs)
    mark(events, "render")
    image = out["render"]
    if mcfg.use_decoupled_appearance and app_params is not None:
        transformed, (top, left, Hc, Wc) = appearance_transform(
            AppearanceNetwork(), app_params, image, view_idx)
        ll1 = l1_loss(transformed, gt_image[:, top:top + Hc, left:left + Wc])
    else:
        ll1 = l1_loss(image, gt_image)

    # normal-consistency regularisation (train.py:141-155)
    reg_on = float(iteration >= ocfg.regularization_from_iter)
    if mcfg.use_coord_map:
        ref_normals = point_double_to_normal(camera, out["expected_coord"], out["median_coord"])
    else:
        ref_normals = depth_double_to_normal(camera, out["expected_depth"], out["median_depth"])
    err = 1.0 - torch.sum(out["normal"][None] * ref_normals, dim=1)  # (2, H, W)
    depth_ratio = 0.6
    dn_loss = (1 - depth_ratio) * torch.mean(err[0]) + depth_ratio * torch.mean(err[1])

    rgb_loss = (1.0 - ocfg.lambda_dssim) * ll1 + ocfg.lambda_dssim * (1.0 - ssim(image, gt_image))
    loss = rgb_loss + reg_on * ocfg.lambda_depth_normal * dn_loss
    mark(events, "loss")

    b = out["binning"]
    aux = {
        "loss": loss.detach(),
        "l1": ll1.detach(),
        "depth_normal_loss": dn_loss.detach(),
        "radii": out["radii"].detach(),
        "visibility": out["visibility_filter"],
        "psnr": -10.0 * torch.log10(torch.mean((image.detach() - gt_image) ** 2)),
        "n_overflow": b.n_overflow,
        "n_instances": b.n_instances,
        "tile_overflow": b.tile_overflow,
    }
    return loss, aux


METRICS = ("loss", "l1", "depth_normal_loss", "psnr", "n_overflow", "tile_overflow",
           "n_instances")


def make_train_step(mcfg: ModelConfig, ocfg: OptimizationConfig, pcfg: PipelineConfig,
                    spatial_lr_scale: float):
    """The train step for these configurations: ``step(ts, camera, gt_image,
    bg, view_idx, width, height, events=None) -> (ts, metrics)``.
    ``events``: a list that receives (stage, torch.cuda.Event) at the start
    and after the render, loss, backward, Adam and statistics stages."""

    def train_step(ts: TrainState, camera, gt_image, bg, view_idx, width, height,
                   events: list | None = None):
        g = ts.gaussians
        it = ts.iteration + 1
        mark(events, "start")
        params = g.params.map(lambda x: x.detach().requires_grad_(True))
        app = (None if ts.app_params is None else
               map_app(lambda x: x.detach().requires_grad_(True), ts.app_params))
        xy_offset = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
        xy_abs = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
        loss, aux = compute_loss(g.replace(params=params), app, xy_offset, xy_abs, camera,
                                 gt_image, bg, it, mcfg, ocfg, pcfg, view_idx, events=events)
        loss.backward()
        mark(events, "backward")

        with torch.no_grad():
            # Adam on the Gaussian groups with the exp-decayed xyz LR
            # (gaussian_model.py:338-361)
            lrs = GroupLRs(
                xyz=expon_lr(it, ocfg.position_lr_init * spatial_lr_scale,
                             ocfg.position_lr_final * spatial_lr_scale,
                             ocfg.position_lr_max_steps,
                             lr_delay_mult=ocfg.position_lr_delay_mult),
                f_dc=ocfg.feature_lr, f_rest=ocfg.feature_lr / 20.0,
                opacity=ocfg.opacity_lr, scaling=ocfg.scaling_lr, rotation=ocfg.rotation_lr)
            grads = params.map(lambda x: torch.zeros_like(x) if x.grad is None else x.grad)
            g = adam_step(g, grads, lrs)
            app_state = {}
            if app is not None:
                app_state = appearance_adam(app, ts.app_m, ts.app_v, it, ocfg)
            mark(events, "adam")

            # densification statistics (train.py:186-188): the screen
            # gradient arrives in pixel units -> NDC units via (W/2, H/2)
            ndc_scale = torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32,
                                     device=g.device)
            g = gm.add_densification_stats(g, xy_offset.grad * ndc_scale, xy_abs.grad[:, 0],
                                           aux["visibility"])
            g = gm.update_max_radii(g, aux["radii"], aux["visibility"])
            mark(events, "stats")
        return ts.replace(gaussians=g, iteration=it, **app_state), {k: aux[k] for k in METRICS}

    return train_step


def appearance_adam(app, app_m, app_v, it: int, ocfg: OptimizationConfig) -> dict:
    """The appearance Adam of loop.py:181-202: dense over every tensor (rows
    of the embedding table that got no gradient still move with their
    moments), bias corrections in float32 from the loop's step ``it``.
    ``app``: the parameters after backward (``.grad`` set or None)."""
    bc1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** it)
    bc2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** it)

    def upd(p, m, v, lr):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        return p.detach() - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS), m, v

    net = {k: upd(app["net"][k], app_m["net"][k], app_v["net"][k], ocfg.appearance_network_lr)
           for k in app["net"]}
    emb = upd(app["embeddings"], app_m["embeddings"], app_v["embeddings"],
              ocfg.appearance_embeddings_lr)
    return {key: {"net": {k: v[i] for k, v in net.items()}, "embeddings": emb[i]}
            for i, key in enumerate(("app_params", "app_m", "app_v"))}


def densify_step(g: gm.GaussianState, generator, max_grad, min_opacity, extent,
                 prune_big_ws, percent_dense=0.01):
    return gm.densify_and_prune(g, generator, max_grad, min_opacity, extent,
                                percent_dense=percent_dense, prune_big_ws=prune_big_ws)


class SceneLike(NamedTuple):
    cameras: list  # [(Camera, gt_image (3, H, W), view_idx)]
    extent: float


class StopTraining(Exception):
    """Raised by a train() callback to end the loop early (wall-clock
    budgets): train() then returns the current state and history."""


def autotune_pipeline(pcfg: PipelineConfig, n_ovf: float, t_ovf: float, window_peak: float,
                      capacity: int, shrink_check: bool) -> tuple[PipelineConfig, bool]:
    """One application of the work-buffer policy (loop.py:238-299): grow the
    instance budget on overflow (to 1.3x the window's peak demand, and at
    least 1.5x), shrink it when the peak leaves it oversized by at least a
    segment and 15%, and double ``max_per_tile`` on a tile overflow (up to
    ``MAX_PER_TILE_CAP``). Returns (new_pcfg, changed)."""
    changed = False
    budget = instance_budget(pcfg, capacity)
    target = round_budget(window_peak * 1.3)
    if n_ovf > 0 and budget < MAX_INSTANCE_BUDGET:
        new_budget = min(max(target, round_budget(budget * 3 // 2)), MAX_INSTANCE_BUDGET)
        pcfg = replace_cfg(pcfg, instance_budget=new_budget)
        print(f"[radegs] instance overflow ({n_ovf:.0f}): growing budget "
              f"{budget} -> {new_budget}", flush=True)
        changed = True
    elif n_ovf > 0:
        print(f"[radegs] instance overflow ({n_ovf:.0f}) at the {MAX_INSTANCE_BUDGET} "
              "budget cap — rendering truncated", flush=True)
    if (not changed and shrink_check and target < budget
            and budget - target >= max(min(BUDGET_SEG, budget // 2), budget * 3 // 20)):
        pcfg = replace_cfg(pcfg, instance_budget=target)
        print(f"[radegs] budget underused (peak {window_peak:.0f}/{budget}): "
              f"shrinking to {target}", flush=True)
        changed = True
    if t_ovf > 0 and pcfg.max_per_tile < MAX_PER_TILE_CAP:
        pcfg = replace_cfg(pcfg, max_per_tile=pcfg.max_per_tile * 2)
        print(f"[radegs] tile overflow ({t_ovf:.0f}): growing max_per_tile to "
              f"{pcfg.max_per_tile}", flush=True)
        changed = True
    return pcfg, changed


def train(
    scene: SceneLike,
    gaussians: gm.GaussianState,
    mcfg: ModelConfig = ModelConfig(),
    ocfg: OptimizationConfig = OptimizationConfig(),
    pcfg: PipelineConfig = PipelineConfig(),
    seed: int = 0,
    log_every: int = 50,
    callbacks=(),
    resume_state: TrainState | None = None,
    mesh=None,
    device=None,
    step_events: list | None = None,
):
    """Single-card training on the schedule of train.py:91-214: SH degree
    up every 1000 iterations, densify / prune every ``densification_interval``
    inside the densify window (then the 3D filter refresh and a capacity
    check), opacity reset every ``opacity_reset_interval``, the 3D filter
    refreshed every 100 iterations after the window, and the work buffers
    autotuned every iteration from the previous step's counters.

    ``device``: default ``cuda`` (raises without a card); the Gaussian state
    must live there. Views are drawn as the JAX package draws them
    (``numpy.random.default_rng(seed)`` permutations); the densify draws come
    from a ``torch.Generator`` seeded with ``seed``, the appearance network's
    initialisation (``mcfg.use_decoupled_appearance``) from one seeded with
    ``seed + 1``.
    ``step_events``: a list that receives, per iteration, the step's list of
    (stage, torch.cuda.Event) marks, followed by "densify" / "reset_opacity"
    marks on the iterations that ran them (CUDA only).
    Returns (train_state, history): ``history`` holds the metrics as floats
    at every ``log_every``-th iteration and the last."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    dev = resolve_device(device)
    if gaussians.device.type != dev.type:
        raise ValueError(f"the Gaussian state lives on {gaussians.device}, not on {dev}")
    cameras = [(cam if cam.device.type == dev.type else cam.to(dev), gt.to(dev), vidx)
               for cam, gt, vidx in scene.cameras]
    cam_list = [c[0] for c in cameras]
    generator = torch.Generator(device=dev).manual_seed(seed)

    if resume_state is not None:
        ts = resume_state
    elif mcfg.use_decoupled_appearance:
        cam0 = cam_list[0]
        ts = init_train_state(gaussians, True, cam0.height, cam0.width,
                              generator=torch.Generator(device=dev).manual_seed(seed + 1))
    else:
        ts = init_train_state(gaussians)
    bg = torch.full((3,), 1.0 if mcfg.white_background else 0.0, device=dev)
    if mcfg.disable_filter3D:
        ts = ts.replace(gaussians=gm.reset_3d_filter(ts.gaussians))
    else:
        ts = ts.replace(gaussians=gm.update_3d_filter(ts.gaussians, cam_list))

    step_fn = make_train_step(mcfg, ocfg, pcfg, spatial_lr_scale=scene.extent)
    rng = np.random.default_rng(seed)
    stack = []
    history = []
    prev_metrics = None  # overflow is checked every iteration, one step late
    window_peak = 0.0  # peak n_instances since the last budget-shrink check
    for it in range(ts.iteration + 1, ocfg.iterations + 1):
        if it % 1000 == 0:
            ts = ts.replace(gaussians=gm.oneup_sh_degree(ts.gaussians))
        if not stack:
            stack = list(rng.permutation(len(cameras)))
        cam, gt, vidx = cameras[int(stack.pop())]
        events = [] if step_events is not None else None
        ts, metrics = step_fn(ts, cam, gt, bg, vidx, cam.width, cam.height, events=events)

        if it < ocfg.densify_until_iter:
            if it > ocfg.densify_from_iter and it % ocfg.densification_interval == 0:
                g2, _ = densify_step(ts.gaussians, generator, ocfg.densify_grad_threshold,
                                     0.05, scene.extent, it > ocfg.opacity_reset_interval,
                                     percent_dense=ocfg.percent_dense)
                if not mcfg.disable_filter3D:
                    g2 = gm.update_3d_filter(g2, cam_list)
                ts = ts.replace(gaussians=gm.maybe_grow(g2))
                mark(events, "densify")
            if it % ocfg.opacity_reset_interval == 0 or (
                    mcfg.white_background and it == ocfg.densify_from_iter):
                ts = ts.replace(gaussians=gm.reset_opacity(ts.gaussians))
                mark(events, "reset_opacity")
        elif it % 100 == 0 and not mcfg.disable_filter3D and it < ocfg.iterations - 100:
            ts = ts.replace(gaussians=gm.update_3d_filter(ts.gaussians, cam_list))
        if events is not None:
            step_events.append(events)

        if it % log_every == 0 or it == ocfg.iterations:
            m = {k: float(v) for k, v in metrics.items()}
            m["iteration"] = it
            m["n_active"] = int(ts.gaussians.n_active())
            history.append(m)
        else:
            m = None

        # autotune the work buffers against the PREVIOUS step's counters: that
        # step has finished by the time this one is enqueued
        if prev_metrics is not None:
            window_peak = max(window_peak, float(prev_metrics["n_instances"]))
            pcfg, changed = autotune_pipeline(
                pcfg, float(prev_metrics["n_overflow"]), float(prev_metrics["tile_overflow"]),
                window_peak, ts.gaussians.capacity, shrink_check=(it % 100 == 0))
            if it % 100 == 0:
                window_peak = 0.0
            if changed:
                step_fn = make_train_step(mcfg, ocfg, pcfg, spatial_lr_scale=scene.extent)
        prev_metrics = metrics
        # callbacks run every iteration; m holds floats at log points, else None
        try:
            for cb in callbacks:
                cb(it, ts, m)
        except StopTraining:
            break
    return ts, history
