"""Headline benchmark (port of ``bench.py``): rays/s per card, forward +
backward, 1600x1200.

Runs one full training step (render -> L1 + SSIM + normal-consistency loss
-> backward through the blend kernels and autograd -> Adam ->
densification statistics) on the JAX bench's synthetic scenes at the DTU
resolution, times it after warm-up, and prints ONE JSON line last:

    python -m radegs_torch.scripts.bench                    # 100k, then dense --auto
    python -m radegs_torch.scripts.bench --scene dense --auto --trace out/trace
    python -m radegs_torch.scripts.bench --scene 100k --no-parity --device cpu

``vs_baseline``: the denominator is the JAX bench's documented estimate of
the CUDA reference's training throughput on its intended hardware: ~20
train-iters/s at 1600x1200 on an RTX-3090-class GPU (the RaDe-GS paper
reports 3DGS-comparable minutes per 30k-iteration training) = 38.4M rays/s.
It is not a measurement of this port or of any accelerator.

``kernel_parity_max_err``: the blend kernels (forward and backward, one and
two tiles a block) against their plain PyTorch versions at a small size,
in the same run: absolute for the forward accumulators, the mismatch share
for ``med_pos``, relative to each output's max for the gradients.

``stages_ms``: the median over the timed steps of each stage of
``bench_breakdown`` (CUDA events of the step itself; None on the CPU).
``compile_wall_s``: the seconds this process spent building the kernels
with nvcc (0 when they were already built). A failure exits non-zero: no
fallback hides the device or a kernel.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

BASELINE_RAYS_PER_S = 20.0 * 1600 * 1200  # documented estimate, see module docstring

WIDTH, HEIGHT = 1600, 1200
N_GAUSS = 100_000
CAPACITY = 131_072
WARMUP = 2
ITERS = 10

# --scene dense: converged-scene analogue, splats ON SURFACES at realistic
# density (a Mip-360-class run converges to 1-6M small splats)
DENSE_N = 1_200_000
DENSE_CAPACITY = 1 << 21

AUTO_ROUNDS = 8  # the --auto settle loop's most rounds
TRACE_STEPS = 3


def build_scene(seed=0, scene="100k", device=None):
    """The JAX bench's scene (bench.py:88-140) on ``device`` (default
    ``cuda``): ``(state, camera, gt)``. The numpy draws are the JAX bench's,
    in its order: the points (``surface_points`` for ``dense``, N(0, 1.2^2)
    for ``100k``), their colours, then the uniform (3, H, W) ground truth.
    ``100k`` shrinks the 3-NN scales by 0.22 so the volumetric cloud fits
    its instance budget; ``dense`` sets every active opacity to 0.8."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.scripts.synthetic import surface_points
    from radegs_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cam = Camera.look_at([0.0, 0.8, -5.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, WIDTH, HEIGHT,
                         device=dev)
    if scene == "dense":
        pts = surface_points(DENSE_N, rng)
        cols = rng.uniform(0.1, 0.9, size=(DENSE_N, 3)).astype(np.float32)
        capacity, shrink = DENSE_CAPACITY, 1.0  # no scale hack: real spacing
    else:
        pts = (rng.normal(size=(N_GAUSS, 3)) * 1.2).astype(np.float32)
        cols = rng.uniform(0.1, 0.9, size=(N_GAUSS, 3)).astype(np.float32)
        capacity, shrink = CAPACITY, 0.22

    state = gm.create_from_points(pts, cols, capacity=capacity, device=dev)
    p = state.params
    if shrink != 1.0:
        p = p.replace(scaling=p.scaling + float(np.log(shrink)))
    if scene == "dense":
        # converged-scene analogue: trained surface splats are opaque
        op = gm.inverse_sigmoid(torch.tensor(0.8, dtype=torch.float32, device=dev))
        p = p.replace(opacity=torch.where(state.active[:, None], op, p.opacity))
    state = gm.update_3d_filter(state.replace(params=p), [cam])
    gt = np.clip(rng.uniform(size=(3, HEIGHT, WIDTH)).astype(np.float32), 0.0, 1.0)
    return state, cam, torch.from_numpy(gt).to(dev)


def parity_inputs(device):
    """The JAX parity check's inputs (bench.py:156-187): seed 3, P = 2000 at
    256x256, SH degree 0, preprocessed and binned with ``instance_budget``
    2^15 and ``max_per_tile`` 512 (with the (T, K) lists the plain versions
    walk). Returns (prep, binning, W, H)."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.core.projection import preprocess_gaussians
    from radegs_torch.ops.rasterize import bin_prep

    rng = np.random.default_rng(3)
    P = 2000
    W = H = 256
    cam = Camera.look_at([0, 0.3, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H, device=device)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    prep = preprocess_gaussians(
        t(rng.normal(size=(P, 3)) * 0.9), t(rng.uniform(0.02, 0.25, (P, 3))),
        t(np.tile([1.0, 0, 0, 0], (P, 1))), t(rng.uniform(0.05, 0.95, (P, 1))),
        t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam, kernel_size=0.1)
    binning = bin_prep(prep, W, H, instance_budget=1 << 15, max_per_tile=512,
                       need_tile_gauss=True)
    return prep, binning, W, H


def parity_error(fwd, fwd_ref, grads, grads_ref):
    """The JAX check's error (bench.py:203-214): the forward's float outputs
    by absolute error, ``med_pos`` by the share that mismatches, each
    gradient by its absolute error over max |reference| (+ 1e-8). Returns
    the maximum."""
    worst = 0.0
    for k, b in fwd_ref.items():
        a = fwd[k]
        err = (a != b).double().mean() if k == "med_pos" else (a - b).abs().max()
        worst = max(worst, float(err))
    for k, b in grads_ref.items():
        err = (grads[k] - b).abs().max() / (b.abs().max() + 1e-8)
        worst = max(worst, float(err))
    return worst


def kernel_parity_check(device=None):
    """The blend kernels against their plain versions on the JAX check's
    inputs (``parity_inputs``), at one tile a block (B1 / B2, the JAX
    check's single-tile kernels) and at two (B3 / B4, what the timed step
    runs), with cotangents of ones on every differentiable output; both
    backwards take the kernel's forward output. Returns the largest
    ``parity_error``. Raises on a CPU device: there the wrappers run the
    plain versions, and there is no kernel to hold."""
    from radegs_torch.core.projection import COLUMNS, column
    from radegs_torch.ops import blend
    from radegs_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel parity check needs a CUDA device, not {dev}")
    prep, binning, W, H = parity_inputs(dev)

    def fields(grad):  # the gradient buffer per field, as the JAX check holds it
        return {**{f: column(grad, f) for f in COLUMNS}, "xy_abs": grad[:, blend.XY_ABS:]}

    fwd_ref = blend.blend_forward_torch(binning.tile_gauss, prep.table, W, H)
    worst = 0.0
    for g in (1, 2):
        fwd = blend.blend_forward(binning, prep.table, W, H, tiles_per_block=g)
        cot = {k: torch.ones_like(fwd[k]) for k in blend.DIFF_KEYS}
        grads = blend.blend_backward(binning, prep.table, fwd, cot, W, H, tiles_per_block=g)
        grads_ref = blend.blend_backward_torch(binning.tile_gauss, prep.table, fwd, cot, W, H)
        worst = max(worst, parity_error(fwd, fwd_ref, fields(grads), fields(grads_ref)))
    return worst


def bench_configs(scene: str, auto: bool):
    """The bench's (ModelConfig, OptimizationConfig, PipelineConfig)
    (bench.py:232-250): ``max_per_tile`` 512 for 100k; for dense the pinned
    steady state (8192, 8 x capacity), or with ``auto`` the package
    defaults that the settle loop starts from."""
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

    if scene == "100k":
        pcfg = PipelineConfig(max_per_tile=512)
    elif auto:
        pcfg = PipelineConfig()
    else:
        pcfg = PipelineConfig(max_per_tile=8192, instance_multiplier=8)
    return ModelConfig(kernel_size=0.1), OptimizationConfig(regularization_from_iter=0), pcfg


def settle(ts, cam, gt, bg, pcfg, step_for, capacity, m0):
    """The ``--auto`` settle loop (bench.py:257-271): from the first step's
    metrics ``m0``, apply ``autotune_pipeline`` (the step's ``n_instances``
    as the window peak, with the shrink check) and, while it changes the
    configuration, build the step for the new one (``step_for(pcfg)``) and
    take a step with it, for at most ``AUTO_ROUNDS`` rounds. Returns (ts,
    pcfg, step, m0, configs): ``configs`` the (max_per_tile,
    instance_budget) of each configuration stepped with, the first
    included."""
    from radegs_torch.train.loop import autotune_pipeline

    step = step_for(pcfg)
    configs = [(pcfg.max_per_tile, pcfg.instance_budget)]
    for _ in range(AUTO_ROUNDS):
        pcfg2, changed = autotune_pipeline(
            pcfg, float(m0["n_overflow"]), float(m0["tile_overflow"]),
            float(m0["n_instances"]), capacity, shrink_check=True)
        if not changed:
            break
        pcfg = pcfg2
        step = step_for(pcfg)
        ts, m0 = step(ts, cam, gt, bg, 0, WIDTH, HEIGHT)
        configs.append((pcfg.max_per_tile, pcfg.instance_budget))
    return ts, pcfg, step, m0, configs


def device_busy_ms(trace_events) -> tuple[float, float]:
    """From a Chrome trace's events: (ms in which the device ran a kernel,
    copy or set, the union of their intervals; ms from the first such event
    to the end of the last)."""
    from radegs_torch.utils import trace

    spans = trace.device_intervals(trace_events)
    if not spans:
        return 0.0, 0.0
    span = max(b for _, b in spans) - spans[0][0]
    idle = sum(b - a for a, b in trace.device_gaps(spans))
    return (span - idle) / 1e3, span / 1e3


def trace_steps(take_step, trace_dir, name, on_card):
    """``TRACE_STEPS`` calls of ``take_step`` (which returns the step's loss)
    under ``torch.profiler``, written as a Chrome trace to
    ``trace_dir/<name>.json``. On a card it also prints the device's busy
    share over the traced device activity (``device_busy_ms``; the
    profiler's own cost slows the host, so an unprofiled step's share is
    no lower)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        for _ in range(TRACE_STEPS):
            loss = take_step()
        float(loss)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    msg = f"# trace of {TRACE_STEPS} steps written to {path}"
    if on_card:
        with open(path) as f:
            busy, span = device_busy_ms(json.load(f)["traceEvents"])
        msg += f"; device busy {busy:.3f} ms of {span:.3f} ms ({busy / max(span, 1e-9):.3f})"
    print(msg, flush=True)


def run_scene(scene="100k", auto=False, parity=True, trace=None, device=None,
              details=None):
    """One scene of the bench (the counterpart of bench.py:218-315): the
    first step, the overflow report (with ``auto`` the settle loop first),
    ``WARMUP`` steps, then ``ITERS`` steps between two synchronisations on
    the host clock, each with CUDA-event marks on a card. Returns the
    scene's record; ``details`` (a dict), when given, receives the set-up
    seconds, the settle's configurations, the number of steps taken, the
    timed steps' metrics as floats and the peak of
    ``torch.cuda.max_memory_allocated``."""
    from radegs_torch.native import build
    from radegs_torch.scripts.bench_breakdown import rounded, stage_fields, step_stages
    from radegs_torch.train.loop import init_train_state, make_train_step
    from radegs_torch.utils.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    build_s0 = build.build_wall_s()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, cam, gt = build_scene(scene=scene, device=dev)
    sync()
    setup_s = time.perf_counter() - t0
    ts = init_train_state(state)
    capacity = state.capacity
    del state
    bg = torch.zeros(3, device=dev)
    mcfg, ocfg, pcfg = bench_configs(scene, auto)

    def step_for(p):
        return make_train_step(mcfg, ocfg, p, spatial_lr_scale=5.0)

    step = step_for(pcfg)
    ts, m0 = step(ts, cam, gt, bg, 0, WIDTH, HEIGHT)
    n_steps = 1
    configs = [(pcfg.max_per_tile, pcfg.instance_budget)]
    if auto:
        ts, pcfg, step, m0, configs = settle(ts, cam, gt, bg, pcfg, step_for, capacity, m0)
        n_steps += len(configs) - 1
        print(f"# auto-tuned config: max_per_tile={pcfg.max_per_tile} "
              f"instance_budget={pcfg.instance_budget}", flush=True)
    novf, tovf = float(m0["n_overflow"]), float(m0["tile_overflow"])
    if novf > 0 or tovf > 0:
        print(f"# WARNING overflow: instances {novf:.0f} tiles {tovf:.0f}", flush=True)

    for _ in range(WARMUP):
        ts, metrics = step(ts, cam, gt, bg, 0, WIDTH, HEIGHT)
        float(metrics["loss"])
    sync()
    marks, timed = [], []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        events = [] if on_card else None
        ts, metrics = step(ts, cam, gt, bg, 0, WIDTH, HEIGHT, events=events)
        timed.append(metrics)
        if on_card:
            marks.append(events)
    float(metrics["loss"])
    sync()
    dt = (time.perf_counter() - t0) / ITERS
    n_steps += WARMUP + ITERS

    if trace:
        def take_step():
            nonlocal ts
            ts, m = step(ts, cam, gt, bg, 0, WIDTH, HEIGHT)
            return m["loss"]

        trace_steps(take_step, trace, f"bench_{scene}", on_card)
        n_steps += TRACE_STEPS

    err = None
    if parity:
        t0 = time.perf_counter()
        err = kernel_parity_check(dev)
        print(f"# kernel parity check: {err:.3e} ({time.perf_counter() - t0:.0f}s)",
              flush=True)

    rays_per_s = WIDTH * HEIGHT / dt
    suffix = "" if scene == "100k" else f"_{scene}"
    rec = {
        "metric": f"rays_per_s_per_chip_fwd_bwd_1600x1200{suffix}",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
    }
    if err is not None:
        rec["kernel_parity_max_err"] = float(f"{err:.3e}")
    rec["compile_wall_s"] = round(build.build_wall_s() - build_s0, 1)
    rec["stages_ms"] = (rounded(stage_fields([step_stages(ev) for ev in marks], dt * 1e3))
                        if on_card else None)
    if details is not None:
        details.update(
            setup_s=setup_s, configs=configs, n_steps=n_steps, step_ms=dt * 1e3,
            steps=[{k: float(v) for k, v in m.items()} for m in timed],
            first={k: float(v) for k, v in m0.items()},
            peak_bytes=int(torch.cuda.max_memory_allocated(dev)) if on_card else None)
    return rec


def main(argv=None, details=None):
    """Parse ``argv``, run the scene(s), print the record as the last line
    and return it. ``--scene both`` (the default) runs 100k, frees it, then
    dense with ``--auto --no-parity`` in this process, and merges the two
    as bench.py:425-440 does (``value_dense``, ``vs_baseline_dense`` and the
    other ``*_dense`` fields). ``details`` (a dict), when given, receives
    each scene's ``run_scene`` details under its name."""
    from radegs_torch.utils.device import add_device_arg, resolve_device

    ap = argparse.ArgumentParser(description="radegs_torch headline bench")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler Chrome trace of 3 steps to DIR")
    ap.add_argument("--scene", choices=["100k", "dense", "both"], default="both",
                    help="'dense': 1.2M surface splats at true 3-NN scales; 'both' "
                         "(default): 100k, then dense --auto, merged into one line")
    ap.add_argument("--auto", action="store_true",
                    help="start from the default PipelineConfig and settle the "
                         "training loop's budget policy before timing")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the kernel parity check")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def run(scene, auto, parity):
        d = {} if details is not None else None
        rec = run_scene(scene, auto=auto, parity=parity, trace=args.trace, device=dev,
                        details=d)
        if details is not None:
            details[scene] = d
        return rec

    if args.scene != "both":
        rec = run(args.scene, args.auto, not args.no_parity)
    else:
        rec = run("100k", args.auto, not args.no_parity)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        drec = run("dense", True, False)
        rec["value_dense"] = drec["value"]
        rec["vs_baseline_dense"] = drec["vs_baseline"]
        rec["compile_wall_s_dense"] = drec["compile_wall_s"]
        rec["stages_ms_dense"] = drec["stages_ms"]
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
