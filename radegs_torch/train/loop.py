"""The training loop (port of ``radegs_tpu/train/loop.py``; reference
train.py:61-214): one ``train_step`` (render -> loss -> backward through the
blend kernel and, on a card, the preprocess backward kernel, or autograd
through the plain preprocess on the CPU -> Adam -> densification
statistics), and densify / prune / opacity reset on the reference's
schedule. PyTorch runs eagerly, so plain Python takes the place of the JAX
package's ``jax.jit``; nothing is wrapped in ``torch.compile``.

Decoupled appearance (``models/appearance.py``) trains beside the Gaussians
with the same explicit Adam arithmetic, dense over the whole network and
embedding table, on the loop's own step count. With ``mesh`` (a
``parallel.Mesh1D``) every rank runs the loop on its block of the Gaussians
through the multi-rank step of ``parallel/step.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from radegs_torch import parallel as par
from radegs_torch.core.geometry import depth_double_to_normal, point_double_to_normal
from radegs_torch.models import gaussian_model as gm
from radegs_torch.models.appearance import appearance_transform, init_appearance
from radegs_torch.ops.binning import (
    BUDGET_SEG,
    MAX_PER_TILE_CAP,
    budget_cap,
    default_instance_budget,
    round_budget,
)
from radegs_torch.ops.ssim import l1_loss, ssim
from radegs_torch.parallel.comm import replicas_agree
from radegs_torch.renderer import render
from radegs_torch.train.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    replace as replace_cfg,
)
from radegs_torch.train.optim import GroupLRs, adam_and_stats, appearance_adam, expon_lr
from radegs_torch.utils import trace
from radegs_torch.utils.device import resolve_device
from radegs_torch.utils.trace import mark

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
    """The explicit budget, or the capacity-derived default (capped at
    ``budget_cap(capacity)``)."""
    return pcfg.instance_budget or min(
        default_instance_budget(capacity, pcfg.instance_multiplier), budget_cap(capacity))


def compute_loss(gaussians: gm.GaussianState, app_params, xy_offset, xy_abs, camera,
                 gt_image, bg, iteration: int, mcfg: ModelConfig, ocfg: OptimizationConfig,
                 pcfg: PipelineConfig, view_idx: int = 0, events: list | None = None):
    """The loss of train.py:124-162: L1 + D-SSIM, plus the depth-normal
    consistency term from ``regularization_from_iter`` on. With decoupled
    appearance the L1 term compares the transformed centre crop with the gt
    crop; SSIM and PSNR stay on the raw image. Returns (loss, aux).

    Traced, the appearance forward is the span ``loss.appearance`` with the
    gauge ``appearance.pixels`` (the crop's) and the mark ``appearance`` at
    its end; with ``events`` its backward is bracketed by the marks
    ``appearance.bwd_start`` (the multiplier's gradient) and
    ``appearance.bwd`` (the crop's, whole after the network's and the
    downsample's backward), recorded by tensor hooks on the autograd
    thread."""
    out = render(gaussians, camera, bg, kernel_size=mcfg.kernel_size,
                 max_per_tile=pcfg.max_per_tile,
                 instance_budget=instance_budget(pcfg, gaussians.capacity),
                 tiles_per_block=pcfg.tiles_per_block, device=gaussians.device,
                 events=events, xy_offset=xy_offset, xy_abs=xy_abs)
    mark(events, "render")
    with trace.span("loss"):
        image = out["render"]
        if mcfg.use_decoupled_appearance and app_params is not None:
            with trace.span("loss.appearance"):
                hooks = None if events is None else (
                    lambda g: mark(events, "appearance.bwd_start"),
                    lambda g: mark(events, "appearance.bwd"))
                transformed, (top, left, Hc, Wc) = appearance_transform(
                    app_params, image, view_idx, hooks)
                trace.gauge("appearance", "pixels", Hc * Wc)
                mark(events, "appearance")
            ll1 = l1_loss(transformed, gt_image[:, top:top + Hc, left:left + Wc])
        else:
            ll1 = l1_loss(image, gt_image)

        # normal-consistency regularisation (train.py:141-155)
        reg_on = float(iteration >= ocfg.regularization_from_iter)
        if mcfg.use_coord_map:
            ref_normals = point_double_to_normal(camera, out["expected_coord"],
                                                 out["median_coord"])
        else:
            ref_normals = depth_double_to_normal(camera, out["expected_depth"],
                                                 out["median_depth"])
        err = 1.0 - torch.sum(out["normal"][None] * ref_normals, dim=1)  # (2, H, W)
        depth_ratio = 0.6
        dn_loss = (1 - depth_ratio) * torch.mean(err[0]) + depth_ratio * torch.mean(err[1])

        with trace.span("loss.ssim"):
            d_ssim = 1.0 - ssim(image, gt_image)
        rgb_loss = (1.0 - ocfg.lambda_dssim) * ll1 + ocfg.lambda_dssim * d_ssim
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
# the previous step's counters that train()'s autotune reads on the host
# (the multi-rank step adds the last two)
AUTOTUNE_READS = ("n_instances", "n_overflow", "tile_overflow", "n_vis_max", "n_vis_overflow")


def make_train_step(mcfg: ModelConfig, ocfg: OptimizationConfig, pcfg: PipelineConfig,
                    spatial_lr_scale: float):
    """The train step for these configurations: ``step(ts, camera, gt_image,
    bg, view_idx, width, height, events=None) -> (ts, metrics)``.
    ``events``: a list that receives (stage, torch.cuda.Event) at the start
    and after the render, loss and backward stages and after Adam and the
    statistics (``adam_and_stats``, one stage marked ``adam`` then
    ``stats``; with decoupled appearance then its Adam, the span and mark
    ``adam.appearance``, and ``compute_loss``'s appearance marks), with the
    render's and the blend's own marks between them
    (``scripts/bench_breakdown.py`` reads them all); given, the step is
    traced (``utils/trace.py``: a ``step`` unit, or a span of the ``train()``
    iteration that runs it)."""

    def train_step(ts: TrainState, camera, gt_image, bg, view_idx, width, height,
                   events: list | None = None):
        g = ts.gaussians
        with trace.unit("step", events, g.device):
            it = ts.iteration + 1
            mark(events, "start")
            params = g.params.map(lambda x: x.detach().requires_grad_(True))
            app = (None if ts.app_params is None else
                   map_app(lambda x: x.detach().requires_grad_(True), ts.app_params))
            xy_offset = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
            xy_abs = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
            loss, aux = compute_loss(g.replace(params=params), app, xy_offset, xy_abs, camera,
                                     gt_image, bg, it, mcfg, ocfg, pcfg, view_idx, events=events)
            with trace.span("backward"):
                loss.backward()
                mark(events, "backward")

            with torch.no_grad():
                # Adam on the Gaussian groups with the exp-decayed xyz LR
                # (gaussian_model.py:338-361) and the densification
                # statistics (train.py:186-188; the screen gradient arrives
                # in pixel units -> NDC units via (W/2, H/2)): one launch on
                # a card
                with trace.span("adam"):
                    lrs = GroupLRs(
                        xyz=expon_lr(it, ocfg.position_lr_init * spatial_lr_scale,
                                     ocfg.position_lr_final * spatial_lr_scale,
                                     ocfg.position_lr_max_steps,
                                     lr_delay_mult=ocfg.position_lr_delay_mult),
                        f_dc=ocfg.feature_lr, f_rest=ocfg.feature_lr / 20.0,
                        opacity=ocfg.opacity_lr, scaling=ocfg.scaling_lr,
                        rotation=ocfg.rotation_lr)
                    g = adam_and_stats(g, params.map(lambda x: x.grad), lrs, xy_offset.grad,
                                       xy_abs.grad, aux["visibility"], aux["radii"],
                                       (width * 0.5, height * 0.5))
                    mark(events, "adam")
                    mark(events, "stats")
                    app_state = {}
                    if app is not None:
                        with trace.span("adam.appearance"):
                            app_state = appearance_adam(app, ts.app_m, ts.app_v, it,
                                                       ocfg.appearance_network_lr,
                                                       ocfg.appearance_embeddings_lr)
                            mark(events, "adam.appearance")
            return ts.replace(gaussians=g, iteration=it, **app_state), {k: aux[k] for k in METRICS}

    return train_step


# the event's counts, read on the host in one sync and set as the gauges
# ``densify.<name>`` of the open unit
DENSIFY_GAUGES = ("cloned", "split", "pruned", "dropped", "active_before", "active")
MIN_OPACITY = 0.05  # the prune threshold train() passes (train.py:180)


def _to_ranks(g: gm.GaussianState, mesh) -> gm.GaussianState:
    """Canonical full state -> this rank's strided block."""
    return par.shard_gaussian_state(par.to_strided(g, mesh.world), mesh)


def _to_full(g: gm.GaussianState, mesh) -> gm.GaussianState:
    """Every rank's strided block -> canonical full state."""
    return par.to_canonical(par.gather_gaussian_state(g, mesh), mesh.world)


def densify_event(ts: TrainState, it: int, generator, ocfg: OptimizationConfig,
                  mcfg: ModelConfig, extent: float, cam_list, events: list | None = None,
                  mesh=None, draws=None) -> tuple[TrainState, dict | None]:
    """What ``train()`` does after the step of iteration ``it`` inside the
    densify window (train.py:178-192): on the densify schedule
    ``densify_and_prune`` (min opacity 0.05, the world-size prune after
    the first opacity reset), the 3D filter refresh
    over ``cam_list``, and ``maybe_grow``; then the opacity reset on its
    schedule. Returns (ts, counts): ``counts`` the densification's
    ``DENSIFY_GAUGES`` as ints (None on an iteration without one); outside
    the window, or off both schedules, ``ts`` is returned as it is.

    Traced (``events``, or a unit already open), the densification is the
    span ``train.densify`` (a unit of its own when no unit is open) with
    the children ``densify.prune``, ``densify.filter3d`` and
    ``densify.grow``, the marks ``densify.prune``, ``densify.filter3d`` and
    ``densify`` after them, the gauges ``densify.<DENSIFY_GAUGES>`` and
    ``densify.capacity``, read at the event's one host sync (the count
    ``maybe_grow`` needs), and the counter ``densify.grows``; the reset
    marks ``reset_opacity``. ``mesh``: every rank calls with its strided
    block; the event densifies the gathered canonical state with the same
    draws on every rank. ``draws``: the three normal samples of
    ``densify_and_prune`` (default: drawn from ``generator``)."""
    counts = None
    if it >= ocfg.densify_until_iter:
        return ts, counts
    densify = it > ocfg.densify_from_iter and it % ocfg.densification_interval == 0
    reset = it % ocfg.opacity_reset_interval == 0 or (
        mcfg.white_background and it == ocfg.densify_from_iter)
    if densify:
        dev = ts.gaussians.device
        with trace.unit("train.densify", events, dev):
            with trace.span("densify.prune"):
                g = ts.gaussians if mesh is None else _to_full(ts.gaussians, mesh)
                before = g.n_active()
                g, st = gm.densify_and_prune(
                    g, generator, ocfg.densify_grad_threshold, MIN_OPACITY, extent,
                    percent_dense=ocfg.percent_dense,
                    prune_big_ws=it > ocfg.opacity_reset_interval, draws=draws)
                mark(events, "densify.prune")
            if not mcfg.disable_filter3D:
                with trace.span("densify.filter3d"):
                    g = gm.update_3d_filter(g, cam_list)
                    mark(events, "densify.filter3d")
            with trace.span("densify.grow"):
                with trace.sync("densify.grow"):
                    counts = dict(zip(DENSIFY_GAUGES, torch.stack(
                        [st["n_clone"], st["n_split"], st["n_prune"], st["n_drop"], before,
                         st["n_active"]]).tolist()))
                for k, v in counts.items():
                    trace.gauge("densify", k, v)
                capacity = g.capacity
                g = gm.maybe_grow(g, n_active=counts["active"])
                trace.gauge("densify", "capacity", g.capacity)
                if g.capacity != capacity:
                    trace.count("densify", "grows")
                if mesh is not None:
                    check_replicas(g, mesh)
                    g = _to_ranks(g, mesh)
                mark(events, "densify")
        ts = ts.replace(gaussians=g)
    if reset:
        ts = ts.replace(gaussians=gm.reset_opacity(ts.gaussians))
        mark(events, "reset_opacity")
    return ts, counts


class Autotune:
    """The loop's work-buffer autotune as ``train()`` keeps it between
    steps: the pipeline config, the step ``make_step`` built for it
    (``step``), the previous step's metrics (read one step late: that step
    has finished by the time the next is enqueued), the peaks since the
    last shrink check, and the counters it read last (``read``, None
    before the second step)."""

    def __init__(self, pcfg: PipelineConfig, make_step):
        self.pcfg, self.make_step = pcfg, make_step
        self.step = make_step(pcfg)
        self.prev = None
        self.read = None
        self.window_peak = 0.0
        self.vis_peak = 0.0

    def after(self, it: int, metrics: dict, capacity: int, mesh=None):
        """``autotune_pipeline`` against the previous step's counters, on
        ``capacity`` (a rank's with ``mesh``), with the shrink check every
        100 iterations; rebuilds ``step`` on a change. Then ``metrics``
        become the previous step's."""
        if self.prev is not None:
            with trace.span("train.autotune"):
                with trace.sync("train.autotune",
                                sum(k in self.prev for k in AUTOTUNE_READS)):
                    prev = {k: float(self.prev.get(k, 0.0)) for k in AUTOTUNE_READS}
                self.read = prev
                self.window_peak = max(self.window_peak, prev["n_instances"])
                self.vis_peak = max(self.vis_peak, prev["n_vis_max"])
                self.pcfg, changed = autotune_pipeline(
                    self.pcfg, prev["n_overflow"], prev["tile_overflow"], self.window_peak,
                    capacity * (1 if mesh is None else mesh.world),
                    shrink_check=(it % 100 == 0), vis_ovf=prev["n_vis_overflow"],
                    vis_peak=self.vis_peak, per_shard_cap=0 if mesh is None else capacity)
                if it % 100 == 0:
                    self.window_peak = 0.0
                    self.vis_peak = 0.0
                if changed:
                    self.step = self.make_step(self.pcfg)
        self.prev = metrics


def after_step(ts: TrainState, it: int, metrics: dict, tune: Autotune, generator,
               ocfg: OptimizationConfig, mcfg: ModelConfig, extent: float, cam_list,
               events: list | None = None, mesh=None,
               draws=None) -> tuple[TrainState, dict | None]:
    """What ``train()`` does after the step of iteration ``it`` (its
    ``metrics``): inside the densify window ``densify_event``, after it the
    3D filter refresh every 100 iterations; then ``tune.after`` on the
    capacity that leaves. Returns (ts, counts) as ``densify_event``."""
    counts = None
    if it < ocfg.densify_until_iter:
        ts, counts = densify_event(ts, it, generator, ocfg, mcfg, extent, cam_list, events,
                                   mesh, draws)
    elif it % 100 == 0 and not mcfg.disable_filter3D and it < ocfg.iterations - 100:
        ts = ts.replace(gaussians=gm.update_3d_filter(ts.gaussians, cam_list))
    tune.after(it, metrics, ts.gaussians.capacity, mesh)
    return ts, counts


class SceneLike(NamedTuple):
    cameras: list  # [(Camera, gt_image (3, H, W), view_idx)]
    extent: float


class StopTraining(Exception):
    """Raised by a train() callback to end the loop early (wall-clock
    budgets): train() then returns the current state and history."""


def autotune_pipeline(pcfg: PipelineConfig, n_ovf: float, t_ovf: float, window_peak: float,
                      capacity: int, shrink_check: bool, vis_ovf: float = 0.0,
                      vis_peak: float = 0.0,
                      per_shard_cap: int = 0) -> tuple[PipelineConfig, bool]:
    """One application of the work-buffer policy (loop.py:238-323): grow the
    instance budget on overflow (to 1.3x the window's peak demand, and at
    least 1.5x, up to ``budget_cap(capacity)``), shrink it when the peak
    leaves it oversized by at least a segment and 15%, and double
    ``max_per_tile`` on a tile overflow (up to ``MAX_PER_TILE_CAP``).
    Multi-rank training (``per_shard_cap``, the per-rank capacity, > 0) also tunes the gather cap ``vis_capacity``: up
    on ``vis_ovf`` (to 1.3x the worst-rank visible peak ``vis_peak``, and at
    least 2x), down to 1.5x the peak on a ``shrink_check``, in powers of two
    of at least 4096, never above ``per_shard_cap``. Returns (new_pcfg,
    changed)."""
    changed = False
    cap = budget_cap(capacity)
    budget = instance_budget(pcfg, capacity)
    target = round_budget(window_peak * 1.3, cap=cap)
    if n_ovf > 0 and budget < cap:
        new_budget = min(max(target, round_budget(budget * 3 // 2, cap=cap)), cap)
        pcfg = replace_cfg(pcfg, instance_budget=new_budget)
        print(f"[radegs] instance overflow ({n_ovf:.0f}): growing budget "
              f"{budget} -> {new_budget}", flush=True)
        changed = True
    elif n_ovf > 0:
        print(f"[radegs] instance overflow ({n_ovf:.0f}) at the {cap} "
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
    if per_shard_cap:
        cur_v = min(pcfg.vis_capacity, per_shard_cap) if pcfg.vis_capacity else per_shard_cap

        def v_bucket(x):
            return min(per_shard_cap, max(1 << 12, 1 << (int(x) - 1).bit_length()))

        if vis_ovf > 0 and cur_v < per_shard_cap:
            new_v = min(per_shard_cap, max(v_bucket(vis_peak * 1.3), cur_v * 2))
            pcfg = replace_cfg(pcfg, vis_capacity=new_v)
            print(f"[radegs] vis overflow ({vis_ovf:.0f}): growing gather cap {cur_v} -> "
                  f"{new_v}", flush=True)
            changed = True
        elif shrink_check and vis_peak > 0 and v_bucket(vis_peak * 1.5) < cur_v:
            new_v = v_bucket(vis_peak * 1.5)
            pcfg = replace_cfg(pcfg, vis_capacity=new_v)
            print(f"[radegs] gather cap underused (worst-rank peak {vis_peak:.0f}/{cur_v}): "
                  f"shrinking to {new_v}", flush=True)
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
    """Training on the schedule of train.py:91-214: SH degree up every 1000
    iterations, densify / prune every ``densification_interval`` inside the
    densify window (then the 3D filter refresh and a capacity check),
    opacity reset every ``opacity_reset_interval``, the 3D filter refreshed
    every 100 iterations after the window, and the work buffers autotuned
    every iteration from the previous step's counters.

    ``device``: default ``cuda`` (raises without a card); the Gaussian state
    must live there. Views are drawn as the JAX package draws them
    (``numpy.random.default_rng(seed)`` permutations); the densify draws come
    from a ``torch.Generator`` seeded with ``seed``, the appearance network's
    initialisation (``mcfg.use_decoupled_appearance``) from one seeded with
    ``seed + 1``.
    ``mesh``: this rank's ``parallel.Mesh1D``; every rank of it calls
    ``train`` with the same arguments and the full state. The ranks then
    train their blocks of the strided layout (``parallel/rebalance.py``)
    with the multi-rank step: bands of every view, the gather capped at
    ``pcfg.vis_capacity`` (autotuned). Around each densification every rank
    gathers the canonical state, densifies it with the same draws (checked
    to agree across ranks) and keeps its block of the result. Callbacks see
    the rank's strided block; logged ``n_active`` counts every rank's. All
    views must share one size. Every rank returns the canonical full state.
    ``step_events``: a list that receives, per iteration, the step's list of
    (stage, torch.cuda.Event) marks, followed by ``densify_event``'s marks
    on the iterations that ran it (CUDA only, single-rank).
    Returns (train_state, history): ``history`` holds the metrics as floats
    at every ``log_every``-th iteration and the last."""
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

    if mesh is None:
        def make_step(pcfg_):
            return make_train_step(mcfg, ocfg, pcfg_, spatial_lr_scale=scene.extent)
    else:
        W, H = cam_list[0].width, cam_list[0].height
        if any((c.width, c.height) != (W, H) for c in cam_list):
            raise ValueError("multi-rank training needs views of one size")
        _, _, h_pad = par.band_layout(H, mesh.world)
        cameras = [(cam, par.pad_gt(gt, h_pad), vidx) for cam, gt, vidx in cameras]

        def make_step(pcfg_):
            inner = par.make_sharded_train_step(mcfg, ocfg, pcfg_, scene.extent, mesh, W, H,
                                                vis_capacity=pcfg_.vis_capacity or None)

            def step(ts_, cam, gt, bg_, vidx, width, height, events=None):
                return inner(ts_, cam, gt, bg_, vidx)

            return step

        ts = ts.replace(gaussians=_to_ranks(ts.gaussians, mesh))

    tune = Autotune(pcfg, make_step)
    rng = np.random.default_rng(seed)
    stack = []
    history = []
    for it in range(ts.iteration + 1, ocfg.iterations + 1):
        if it % 1000 == 0:
            ts = ts.replace(gaussians=gm.oneup_sh_degree(ts.gaussians))
        if not stack:
            stack = list(rng.permutation(len(cameras)))
        cam, gt, vidx = cameras[int(stack.pop())]
        events = [] if step_events is not None else None
        with trace.unit("iteration", events, dev):
            ts, metrics = tune.step(ts, cam, gt, bg, vidx, cam.width, cam.height,
                                    events=events)
            ts, _ = after_step(ts, it, metrics, tune, generator, ocfg, mcfg, scene.extent,
                               cam_list, events, mesh)
            if events is not None:
                step_events.append(events)

            if it % log_every == 0 or it == ocfg.iterations:
                with trace.sync("train.log", len(metrics) + 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    m["iteration"] = it
                    n_act = ts.gaussians.n_active()
                    m["n_active"] = int(n_act if mesh is None else par.psum(n_act, mesh))
                history.append(m)
            else:
                m = None
        # callbacks run every iteration; m holds floats at log points, else None
        try:
            for cb in callbacks:
                cb(it, ts, m)
        except StopTraining:
            break
    if mesh is not None:
        ts = ts.replace(gaussians=_to_full(ts.gaussians, mesh))
    return ts, history


def check_replicas(g: gm.GaussianState, mesh):
    """Raise unless every rank holds the same state after a densification
    (each densifies the gathered state with the same draws): a checksum of
    the parameters, the active count and the capacity."""
    sums = torch.stack([x.detach().to(torch.float64).sum() for _, x in g.params.items()]
                       + [g.n_active().to(torch.float64),
                          torch.tensor(float(g.capacity), dtype=torch.float64,
                                       device=g.device)])
    if not replicas_agree(sums, mesh):
        raise RuntimeError("the ranks' densified states differ: the densify draws or "
                           "compaction were not the same on every rank")
