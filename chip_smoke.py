#!/usr/bin/env python3
"""On-card check of the radegs_torch serving and training paths (run from
the repository root on a machine with one CUDA card: ``python3 chip_smoke.py``).

1. Setup: the card's name and power limit; nvcc builds every kernel under
   radegs_torch/csrc (one process per source, all at once).
2. Kernels against their plain versions on the JAX bench's parity scene
   (bench.py:156-180: 2000 Gaussians, 256x256) and off-centre at 250x190
   (empty and ragged tiles). Forward: the kernel at one and at two tiles per
   block bit-identical; against ``blend_forward_torch`` the float
   accumulators within abs 1e-4 (summation order and FMA contraction
   differ) and ``med_pos`` different at no more than 1e-4 of the pixels.
   Backward, with seeded random cotangents on all eight differentiable raw
   outputs: G=1 and G=2 bit-identical, two runs bit-identical, and each
   gradient field within 1e-4 x max |plain| of ``blend_backward_torch``.
3. The serving path at full width, the bench's headline scene (bench.py
   build_scene("100k")): 100k Gaussians at 1600x1200, SH degree 3 with every
   band live, written with ``save_gaussian_ply`` and read back with
   ``load_gaussian_ply`` on the card, the Mip 3D filter over 8 orbit cameras,
   then ``render`` of the 8 views (after 2 warm-up views) at two tiles per
   block and again at one. Per-stage times from CUDA events, peak memory.
4. Converged scale: the bench's dense scene (1.2M surface splats at opacity
   0.8, 1600x1200, max_per_tile 8192, ~8M instances per view), 2 views with
   the instance budget set from the measured demand. Launch counts are set
   to 0 before phase 3 and read after phase 4 (the serving path).
5. Kernels alone at the 100k view 0: the forward and the backward kernel
   timed in turns (G=1, G=2, G=2, G=1; 20 launches each), their plain
   versions once, each held to the bounds of phase 2, and the least time the
   card could take for their work (bytes and FP32 operations counted from
   this view's inputs).
6. The training path at full width: ``create_from_points`` on the 100k
   scene's centres (jittered, seeded random colours; the KNN at P = 100k),
   the 8 views rendered from the scene as ground truth, then ``train`` for
   100 iterations (densify from 20 every 20 until 90, opacity reset at 80,
   the depth-normal term from 10) at G=2; then 2 train steps on the dense
   scene at G=2 and 2 at G=1. Launch counts are set to 0 before and read
   after. Fails unless every loss and parameter is finite, the mean loss of
   iterations 51-60 is below that of 1-10, densify ran 3 times and the
   opacity reset once, Gaussians are left at the end, no instance overflow
   after the autotune settles, and the backward kernel ran once per
   iteration. Per-stage medians from CUDA
   events, host ms per iteration, peak memory; the backward kernel alone at
   the dense view 0.

``python3 chip_smoke.py --profile`` instead runs the setup and a
torch.profiler pass over both scenes' serving and over 5 training
iterations of the 100k scene (device time by operation, busy share).

Every phase that fails raises, and the script exits non-zero without the
result lines. The last three lines are the card's name and power limit, a
JSON object with a ``kernels`` list, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1600, 1200
N_GAUSS, CAPACITY = 100_000, 131_072
DENSE_N, DENSE_CAPACITY = 1_200_000, 1 << 21
N_VIEWS, WARMUP = 8, 2
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor cores,
# HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (instance, pixel) pair of blend_fwd.cu, an FMA counted
# as 2: a walked pair 19 (2 deltas, 9 for the conic form, the power test,
# ~4 for expf, the opacity product, the 0.99 clamp, the 1/255 test); a
# blended pair 42 more (transmittance 3, weight 1, colour 6, weight sum 1,
# t_ray 4 + 2, coord 12 + 6, normal 6, median test 1)
OPS_WALKED, OPS_BLENDED = 19, 42
# FP32 operations of blend_bwd.cu, counted the same way: a walked pair the
# same 19 as the forward's gate; a blended pair 125 more (transmittance 3,
# weight 1, t_ray 4, coord 12, dL/dw 21, prefix 2, suffix 2, dL/dalpha 3,
# median routing 10, the clip gate 2, dL/dG 1, falloff products 2, e_x and
# e_y 8, xy_abs 5, conic 9, opacity 1, rgb 3, camera_plane 6, ray_plane 2,
# normal 3, and 25 adds into the pixel sums); the segment sum adds 25 per
# instance
OPS_BWD_WALKED, OPS_BWD_BLENDED, OPS_BWD_SEGMENT = 19, 125, 25
ABS_TOL, MED_POS_TOL = 1e-4, 1e-4
BWD_REL_TOL = 1e-4  # of max |plain| per gradient field
TRAIN_ITERS = 100
DENSIFY_LOG = (1, 39, 40, 41, 59, 60, 61, 79, 80, 81, TRAIN_ITERS)
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ scenes ----


def orbit_cameras(n, device):
    from radegs_torch.core.camera import Camera

    cams = []
    for k in range(n):
        th = 2.0 * math.pi * k / n
        eye = [5.0 * math.sin(th), 0.8, -5.0 * math.cos(th)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 0.9, 0.7, WIDTH, HEIGHT,
                                   device=device))
    return cams


def surface_points(n, rng):
    """bench.py _surface_points: a noisy sphere and a ground plane."""
    n_sphere = (2 * n) // 3
    d = rng.normal(size=(n_sphere, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sphere = d * (1.3 + 0.05 * rng.normal(size=(n_sphere, 1)))
    n_plane = n - n_sphere
    plane = np.stack([rng.uniform(-3, 3, n_plane),
                      np.full(n_plane, -1.4) + 0.02 * rng.normal(size=n_plane),
                      rng.uniform(-3, 3, n_plane)], axis=1)
    return np.concatenate([sphere, plane], 0).astype(np.float32)


def scene_ply(path, scene, seed=0):
    """Write the bench scene as a reference-format PLY with the port's
    save_gaussian_ply: points and colours from the seed, scales from the
    exact 3-NN spacing (scipy cKDTree), SH degree 3 with small random
    higher bands."""
    from scipy.spatial import cKDTree

    from radegs_torch.core.sh import rgb2sh
    from radegs_torch.models import gaussian_model as gm

    rng = np.random.default_rng(seed)
    if scene == "dense":
        pts = surface_points(DENSE_N, rng)
        cap, shrink, opacity = DENSE_CAPACITY, 1.0, 0.8
    else:
        pts = (rng.normal(size=(N_GAUSS, 3)) * 1.2).astype(np.float32)
        cap, shrink, opacity = CAPACITY, 0.22, 0.1
    n = pts.shape[0]
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    d2, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    dist2 = np.maximum(np.mean(np.square(d2[:, 1:]), axis=1), 1e-7)
    scales = np.log(np.sqrt(dist2) * shrink)[:, None].repeat(3, axis=1)
    state = gm.state_from_arrays(
        pts, rgb2sh(cols)[:, None, :], rng.normal(size=(n, 15, 3)) * 0.02, scales,
        np.tile([1.0, 0, 0, 0], (n, 1)), np.full((n, 1), math.log(opacity / (1 - opacity))),
        np.ones(n, bool), np.zeros((n, 1)), active_sh_degree=3, device="cpu")
    gm.save_gaussian_ply(path, state)
    return cap


# ------------------------------------------------------------ helpers ----


def compare(kernel, plain):
    """Max abs error over the float accumulators, med_pos mismatch share,
    and the med_t / med_coord error where med_pos agrees."""
    err = 0.0
    for k, v in plain.items():
        if k in ("med_pos", "n_eval", "n_incl", "med_t", "med_coord"):
            continue
        err = max(err, (kernel[k] - v).abs().max().item())
    same = kernel["med_pos"] == plain["med_pos"]
    flips = 1.0 - same.float().mean().item()
    med_err = max((kernel["med_t"] - plain["med_t"]).abs()[same].max().item(),
                  (kernel["med_coord"] - plain["med_coord"]).abs()[:, same].max().item())
    return err, flips, med_err


def bit_identical(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_bound_ms(binning, inputs, work):
    """Least time for the blend's work on these inputs: every input read
    once, every output written once, the walked and blended pairs' FP32
    operations at peak."""
    P = inputs[0].shape[0]
    T = binning.tile_count.shape[0]
    n_bytes = (P * 24 * 4 + binning.gauss_id.numel() * 4 + T * 8
               + T * 17 * 256 * 4 + T * 256 * 4)
    ops = OPS_WALKED * int(work["n_eval"]) + OPS_BLENDED * int(work["n_incl"])
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def backward_bound_ms(binning, inputs, work):
    """Least time for the backward's work on these inputs: features,
    gauss_id, tile ranges, per-tile cotangents + totals (28 rows) and
    med_pos read once; the 25-float instance rows written and read back once,
    with the segment sum's order (N) and ranges (P + 1); the (P, 25) result
    written once. Operations: the walked and blended pairs and the segment
    sum at FP32 peak."""
    P = inputs[0].shape[0]
    T = binning.tile_count.shape[0]
    N = binning.gauss_id.numel()
    n_bytes = (P * 24 * 4 + N * 4 + T * 8 + T * 29 * 256 * 4 + 2 * N * 25 * 4 + N * 4
               + (P + 1) * 4 + P * 25 * 4)
    ops = (OPS_BWD_WALKED * int(work["n_eval"]) + OPS_BWD_BLENDED * int(work["n_incl"])
           + OPS_BWD_SEGMENT * N)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def random_cotangents(fwd, seed):
    """Seeded standard-normal cotangents of the eight differentiable raw outputs."""
    from radegs_torch.ops import blend

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {k: torch.randn(fwd[k].shape, generator=gen, device=DEVICE)
            for k in blend.DIFF_KEYS}


def compare_grads(kernel, plain):
    """Per field: max abs error and that error over max |plain|."""
    out = {}
    for k, v in plain.items():
        err = (kernel[k] - v).abs().max().item()
        out[k] = (err, err / max(v.abs().max().item(), 1e-30))
    return out


def check_backward(binning, inputs, fwd, cot, W, H, label):
    """blend_bwd at G=1 and G=2 bit-identical, two runs bit-identical, each
    field within BWD_REL_TOL of the plain version. Returns the max abs and
    max relative error."""
    from radegs_torch.ops import blend

    b1 = blend.blend_backward(binning, inputs, fwd, cot, W, H, tiles_per_block=1)
    b2 = blend.blend_backward(binning, inputs, fwd, cot, W, H, tiles_per_block=2)
    b2r = blend.blend_backward(binning, inputs, fwd, cot, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    check(bit_identical(b1, b2), f"{label}: blend_bwd G=1 and G=2 are not bit-identical")
    check(bit_identical(b2, b2r), f"{label}: blend_bwd differs between two runs")
    plain = blend.blend_backward_torch(binning.tile_gauss, inputs, fwd, cot, W, H)
    errs = compare_grads(b2, plain)
    log(f"{label} backward: G1==G2 and run==rerun bitwise; per field abs err / rel to max "
        "|plain|: " + ", ".join(f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items()))
    worst = max(r for _, r in errs.values())
    check(worst <= BWD_REL_TOL, f"{label}: backward kernel vs plain rel err {worst}")
    return max(a for a, _ in errs.values()), worst


# ------------------------------------------------------------- phases ----


def setup():
    from radegs_torch.native import build

    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
        + ", ".join(f"{k} {v:.2f} s" for k, v in took.items()))
    for name in took:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def parity_scene(W=256, H=256, target=(0, 0, 0)):
    """Phase 2: kernel vs plain at G=1 and G=2 on bench.py's parity scene
    (and, off-centre at a size that is not a multiple of 16, with empty and
    ragged tiles)."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.core.projection import preprocess_gaussians
    from radegs_torch.ops import blend
    from radegs_torch.ops.rasterize import bin_prep, blend_inputs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    P = 2000
    cam = Camera.look_at([0, 0.3, -4.0], target, [0, 1, 0], 0.9, 0.9, W, H, device=dev)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    prep = preprocess_gaussians(
        t(rng.normal(size=(P, 3)) * 0.9), t(rng.uniform(0.02, 0.25, (P, 3))),
        t(np.tile([1.0, 0, 0, 0], (P, 1))), t(rng.uniform(0.05, 0.95, (P, 1))),
        t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam, kernel_size=0.1)
    binning = bin_prep(prep, W, H, instance_budget=1 << 15, max_per_tile=512,
                       need_tile_gauss=True)
    inputs = blend_inputs(prep)
    plain = blend.blend_forward_torch(binning.tile_gauss, inputs, W, H)
    k1 = blend.blend_forward(binning, inputs, W, H, tiles_per_block=1)
    k2 = blend.blend_forward(binning, inputs, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    check(bit_identical(k1, k2), "blend_fwd G=1 and G=2 are not bit-identical")
    err, flips, med_err = compare(k1, plain)
    log(f"phase 2 parity scene: P={P} {W}x{H} n_instances={int(binning.n_instances)} "
        f"(budget 32768, n_overflow {int(binning.n_overflow)}), empty tiles "
        f"{int((binning.tile_count == 0).sum())} of {binning.tile_count.numel()}, max_tile="
        f"{int(binning.max_tile_count)}: G1==G2 bitwise, max abs err {err:.3e}, "
        f"med_pos flips {flips:.3e}, med_t/med_coord err where med_pos agrees {med_err:.3e}")
    check(err <= ABS_TOL and med_err <= ABS_TOL, f"kernel vs plain error {err}, {med_err}")
    check(flips <= MED_POS_TOL, f"med_pos flips {flips}")
    bwd_abs, bwd_rel = check_backward(binning, inputs, k1, random_cotangents(k1, 11), W, H,
                                      f"phase 2 {W}x{H}")
    return max(err, med_err), bwd_abs, bwd_rel


def serve(state, cameras, max_per_tile, budget, tiles_per_block, label, warmup=0):
    """Render every camera through ``render`` (after ``warmup`` views); raise
    the budget to the measured demand on overflow. Returns per-view stage
    times and binning diagnostics, and the budget used."""
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.renderer import render

    rows = []
    views = [cameras[i % len(cameras)] for i in range(warmup)] + list(cameras)
    for i, cam in enumerate(views):
        for _ in range(2):
            events = []
            t0 = time.perf_counter()
            with torch.no_grad():
                out = render(state, cam, [0.0, 0.0, 0.0], kernel_size=0.1,
                             max_per_tile=max_per_tile, instance_budget=budget,
                             tiles_per_block=tiles_per_block, device=DEVICE,
                             events=events)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            b = out["binning"]
            if int(b.n_overflow) == 0:
                break
            budget = round_budget(int(b.n_instances))
            log(f"  {label}: view {i} overflowed, instance budget -> {budget}")
        check(int(b.n_overflow) == 0, f"{label}: view {i} still overflows at {budget}")
        for k in ("render", "mask", "expected_depth", "median_depth", "expected_coord",
                  "median_coord", "normal"):
            v = out[k]
            check(v.shape[-2:] == (HEIGHT, WIDTH), f"{k} shape {tuple(v.shape)}")
            check(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")
        if i < warmup:
            continue
        ev = dict(events)
        names = ["start", "preprocess", "binning", "blend", "normalize"]
        stages = {n: ev[a].elapsed_time(ev[n]) for a, n in zip(names, names[1:])}
        rows.append(dict(stages, view_ms=ev["start"].elapsed_time(ev["normalize"]),
                         wall_ms=wall, n_instances=int(b.n_instances),
                         n_overflow=int(b.n_overflow), tile_overflow=int(b.tile_overflow),
                         max_tile=int(b.max_tile_count)))
    return rows, budget


def report(label, rows, budget, launches, peak):
    med = {k: float(np.median([r[k] for r in rows]))
           for k in ("preprocess", "binning", "blend", "normalize", "view_ms", "wall_ms")}
    log(f"{label}: {len(rows)} views, instance budget {budget}, median ms: preprocess "
        f"{med['preprocess']:.3f}, binning {med['binning']:.3f}, kernel {med['blend']:.3f}, "
        f"normalisation {med['normalize']:.3f}, per view {med['view_ms']:.3f} (events) / "
        f"{med['wall_ms']:.3f} (host clock); n_instances "
        f"{[r['n_instances'] for r in rows]}, n_overflow {sum(r['n_overflow'] for r in rows)}, "
        f"tile_overflow {[r['tile_overflow'] for r in rows]}, max per tile "
        f"{max(r['max_tile'] for r in rows)}, kernel launches {launches}, "
        f"peak memory {peak / 2**30:.3f} GiB")
    return med


def full_scale(workdir):
    """Phases 3 and 4 (the serving path at full width, then converged scale)
    and phase 5 (the kernels alone at the 100k view 0)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.ops.rasterize import bin_prep, blend_inputs
    from radegs_torch.renderer import prepare

    dev = torch.device(DEVICE)
    cams = orbit_cameras(N_VIEWS, dev)
    results = {}

    # ---- phase 3: 100k headline scene, the serving path ----
    t0 = time.perf_counter()
    path = os.path.join(workdir, "scene100k.ply")
    cap = scene_ply(path, "100k")
    log(f"phase 3 scene written in {time.perf_counter() - t0:.1f} s")
    blend.reset_launches()  # the serving path starts here
    torch.cuda.reset_peak_memory_stats()
    state = gm.update_3d_filter(
        gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
    budget = default_instance_budget(cap)
    rows2, budget = serve(state, cams, 512, budget, 2, "100k G=2", warmup=WARMUP)
    rows1, budget = serve(state, cams, 512, budget, 1, "100k G=1", warmup=1)
    launches_100k = dict(blend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    results["g2"] = report("phase 3 100k 1600x1200 G=2", rows2, budget,
                           launches_100k["blend_fwd[G=2]"], peak)
    results["g1"] = report("phase 3 100k 1600x1200 G=1", rows1, budget,
                           launches_100k["blend_fwd[G=1]"], peak)

    # ---- phase 4: dense converged-scale scene, the serving path continued ----
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dpath = os.path.join(workdir, "dense.ply")
    dcap = scene_ply(dpath, "dense")
    log(f"phase 4 scene written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    state = gm.update_3d_filter(
        gm.load_gaussian_ply(dpath, sh_degree=3, capacity=dcap, device=dev), cams)
    dcams = cams[:2]
    with torch.no_grad():  # the demand of each view sets the budget
        need = 0
        for cam in dcams:
            b = bin_prep(prepare(state, cam, 0.1), WIDTH, HEIGHT,
                         default_instance_budget(dcap), 8192, need_tile_gauss=False)
            need = max(need, int(b.n_instances))
    before = blend.LAUNCHES["blend_fwd[G=2]"]
    rowsd, dbudget = serve(state, dcams, 8192, round_budget(need), 2, "dense G=2")
    results["dense"] = report("phase 4 dense 1.2M 1600x1200 G=2", rowsd, dbudget,
                              blend.LAUNCHES["blend_fwd[G=2]"] - before,
                              torch.cuda.max_memory_allocated())
    launches = dict(blend.LAUNCHES)  # the serving path ends here
    log(f"serving path kernel launches: {launches}")
    check(all(launches[f"blend_fwd[G={g}]"] > 0 for g in (1, 2)),
          f"a forward kernel never ran on the serving path: {launches}")
    del state
    torch.cuda.empty_cache()

    # ---- phase 5: the 100k view 0 through the plain blend on the card, and
    # the kernels timed alone at these shapes (launches here are not counted)
    state = gm.update_3d_filter(gm.load_gaussian_ply(path, sh_degree=3, capacity=cap,
                                                     device=dev), cams)
    with torch.no_grad():
        prep = prepare(state, cams[0], 0.1)
        binning = bin_prep(prep, WIDTH, HEIGHT, budget, 512, need_tile_gauss=True)
        inputs = blend_inputs(prep)
        plain = blend.blend_forward_torch(binning.tile_gauss, inputs, WIDTH, HEIGHT,
                                          count_work=True)
        k2 = blend.blend_forward(binning, inputs, WIDTH, HEIGHT, tiles_per_block=2)
        k1 = blend.blend_forward(binning, inputs, WIDTH, HEIGHT, tiles_per_block=1)
        torch.cuda.synchronize()
        check(bit_identical(k1, k2), "100k: G=1 and G=2 are not bit-identical")
        err, flips, med_err = compare(k2, plain)
        log(f"phase 5 plain blend on the card, view 0: max abs err {err:.3e}, med_pos flips "
            f"{flips:.3e}, med err {med_err:.3e}; pairs walked {int(plain['n_eval'])}, "
            f"blended {int(plain['n_incl'])}")
        check(err <= ABS_TOL and med_err <= ABS_TOL, f"100k kernel vs plain {err}, {med_err}")
        check(flips <= MED_POS_TOL, f"100k med_pos flips {flips}")
        timing = {}
        for rnd in range(2):  # turns: G=1, G=2, G=2, G=1
            for g in ((1, 2) if rnd == 0 else (2, 1)):
                ms = time_ms(lambda g=g: blend.blend_forward(binning, inputs, WIDTH, HEIGHT,
                                                             tiles_per_block=g), 20)
                timing.setdefault(g, []).append(ms)
        plain_ms = time_ms(lambda: blend.blend_forward_torch(binning.tile_gauss, inputs,
                                                             WIDTH, HEIGHT), 1)
        bound, bound_by, n_bytes, ops = kernel_bound_ms(binning, inputs, plain)
        log(f"phase 5 forward kernel alone at 100k view 0 (ms, turns G1,G2,G2,G1): G=1 "
            f"{timing[1]}, G=2 {timing[2]}; plain {plain_ms:.3f}; bound {bound:.4f} ms by "
            f"{bound_by} ({n_bytes} bytes, {ops} FP32 operations)")

        cot = random_cotangents(k2, 12)
        bwd_abs, bwd_rel = check_backward(binning, inputs, k2, cot, WIDTH, HEIGHT,
                                          "phase 5 100k view 0")
        btiming = {}
        for rnd in range(2):  # turns: G=1, G=2, G=2, G=1
            for g in ((1, 2) if rnd == 0 else (2, 1)):
                ms = time_ms(lambda g=g: blend.blend_backward(binning, inputs, k2, cot, WIDTH,
                                                              HEIGHT, tiles_per_block=g), 20)
                btiming.setdefault(g, []).append(ms)
        bplain_ms = time_ms(lambda: blend.blend_backward_torch(binning.tile_gauss, inputs, k2,
                                                               cot, WIDTH, HEIGHT), 1)
        bbound, bbound_by, bn_bytes, bops = backward_bound_ms(binning, inputs, plain)
    log(f"phase 5 backward kernel alone at 100k view 0 (ms, turns G1,G2,G2,G1): G=1 "
        f"{btiming[1]}, G=2 {btiming[2]}; plain {bplain_ms:.3f}; bound {bbound:.4f} ms by "
        f"{bbound_by} ({bn_bytes} bytes, {bops} FP32 operations; {binning.gauss_id.numel()} "
        f"instances)")
    results.update(launches=launches, timing=timing, plain_ms=plain_ms, bound=bound,
                   bound_by=bound_by, err=max(err, med_err), path=path, dpath=dpath, cap=cap,
                   dcap=dcap, cams=cams, budget=budget, dbudget=dbudget, btiming=btiming,
                   bplain_ms=bplain_ms, bbound=bbound, bbound_by=bbound_by, bwd_abs=bwd_abs,
                   bwd_rel=bwd_rel)
    return results


def nerf_extent(cameras):
    """The scene extent of the reference's getNerfppNorm: 1.1 x the largest
    distance of a camera centre from their mean."""
    centres = torch.stack([c.camera_center for c in cameras])
    return float(1.1 * (centres - centres.mean(0)).norm(dim=1).max())


def stage_medians(step_events):
    """Per-stage medians (ms) and counts from each iteration's (stage, event)
    marks: a stage lasts from the previous mark to its own."""
    per = {}
    for events in step_events:
        for (_, a), (name, b) in zip(events, events[1:]):
            per.setdefault(name, []).append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in per.items()}, {k: len(v) for k, v in per.items()}


def training_scene(path, cap, cams, budget):
    """The training set-up: the 8 views rendered from the 100k scene as
    ground truth, and ``create_from_points`` on the scene's centres jittered
    by a seeded sigma = 0.01 with seeded random colours (the KNN at P = 100k).
    Returns (scene, initial state, seconds of create_from_points)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.renderer import render
    from radegs_torch.train.loop import SceneLike

    dev = torch.device(DEVICE)
    scene_state = gm.update_3d_filter(
        gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
    gts = []
    with torch.no_grad():
        for cam in cams:
            out = render(scene_state, cam, [0.0, 0.0, 0.0], kernel_size=0.1, max_per_tile=512,
                         instance_budget=budget, device=DEVICE)
            check(int(out["binning"].n_overflow) == 0, "ground truth render overflowed")
            gts.append(out["render"])
    gen = torch.Generator(device=dev).manual_seed(5)
    xyz = scene_state.params.xyz[scene_state.active]
    pts = xyz + 0.01 * torch.randn(xyz.shape, generator=gen, device=dev)
    cols = torch.rand(xyz.shape, generator=gen, device=dev)
    del scene_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0 = gm.create_from_points(pts, cols, sh_degree=3, device=dev)
    torch.cuda.synchronize()
    scene = SceneLike(cameras=[(c, gt, i) for i, (c, gt) in enumerate(zip(cams, gts))],
                      extent=nerf_extent(cams))
    return scene, g0, time.perf_counter() - t0


def training(res):
    """Phase 6: the training path at full width on the 100k scene, then
    train steps at converged scale, and the backward kernel alone there."""
    from dataclasses import replace

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.ops.rasterize import bin_prep, blend_inputs
    from radegs_torch.renderer import prepare
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import TrainState, make_train_step, train

    dev = torch.device(DEVICE)
    cams = res["cams"]
    scene, g0, knn_s = training_scene(res["path"], res["cap"], cams, res["budget"])
    extent = scene.extent
    mcfg = ModelConfig(kernel_size=0.1)
    # the opacity reset comes after the last densify (both at 80): a densify
    # 20 steps after a reset prunes every Gaussian, since 20 Adam steps cannot
    # lift a reset opacity (0.01) past the 0.05 prune threshold (the
    # reference leaves 100 steps, 3000 and 3100)
    ocfg = OptimizationConfig(iterations=TRAIN_ITERS, densify_from_iter=20,
                              densification_interval=20, densify_until_iter=90,
                              opacity_reset_interval=80, regularization_from_iter=10,
                              position_lr_max_steps=TRAIN_ITERS)
    pcfg = PipelineConfig(max_per_tile=512)
    n0, c0 = int(g0.n_active()), g0.capacity
    log(f"phase 6 set-up: create_from_points of {n0} points (KNN included) {knn_s:.3f} s, "
        f"capacity {c0}, scene extent {extent:.4f}")

    # ---- the training path starts here ----
    blend.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_events, host = [], []
    t0 = time.perf_counter()
    ts, hist = train(scene, g0, mcfg, ocfg, pcfg, seed=0, log_every=1, device=DEVICE,
                     step_events=step_events,
                     callbacks=[lambda it, ts, m: host.append(time.perf_counter())])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches_100 = dict(blend.LAUNCHES)
    losses = [h["loss"] for h in hist]
    first, mid = float(np.mean(losses[:10])), float(np.mean(losses[50:60]))
    n_densify = sum(any(n == "densify" for n, _ in ev) for ev in step_events)
    n_reset = sum(any(n == "reset_opacity" for n, _ in ev) for ev in step_events)
    overflowed = [h["iteration"] for h in hist if h["n_overflow"] > 0]
    med, counts = stage_medians(step_events)
    host_ms = 1e3 * float(np.median(np.diff(host)))
    log(f"phase 6 training 100k 1600x1200 G=2, {TRAIN_ITERS} iterations in {wall:.3f} s: "
        f"median ms per iteration {host_ms:.3f} (host clock); CUDA-event medians ms: "
        + ", ".join(f"{k} {v:.3f} (x{counts[k]})" for k, v in med.items())
        + f"; n_active {n0} -> {int(ts.gaussians.n_active())}, capacity {c0} -> "
        f"{ts.gaussians.capacity}; densify {n_densify}x, opacity reset {n_reset}x; peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches_100}")
    log("  loss per iteration: " + " ".join(f"{x:.5f}" for x in losses))
    log("  n_instances per iteration: " + " ".join(str(int(h["n_instances"])) for h in hist))
    log("  n_active after iterations " + ", ".join(
        f"{h['iteration']}: {h['n_active']}" for h in hist if h["iteration"] in DENSIFY_LOG))
    log(f"  iterations with instance overflow: {overflowed}; tile overflow at "
        f"{[h['iteration'] for h in hist if h['tile_overflow'] > 0]}; psnr first/last "
        f"{hist[0]['psnr']:.3f} / {hist[-1]['psnr']:.3f}")
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(x) for x in losses),
          "training losses not finite")
    for name, p in ts.gaussians.params.items():
        check(bool(torch.isfinite(p).all()), f"parameter {name} not finite after training")
    check(mid < first, f"loss did not fall: iterations 1-10 {first}, 51-60 {mid}")
    check(n_densify >= 3 and n_reset == 1, f"densify ran {n_densify}x, reset {n_reset}x")
    check(hist[-1]["n_active"] > 0, "training ended with no Gaussian")
    check(all(h["n_overflow"] == 0 for h in hist[-20:]),
          f"instance overflow after the autotune settled: {overflowed}")
    check(launches_100["blend_bwd[G=2]"] == TRAIN_ITERS,
          f"blend_bwd[G=2] launched {launches_100['blend_bwd[G=2]']}x in {TRAIN_ITERS} steps")
    results = dict(train_med=med, train_host_ms=host_ms, train_peak=peak, loss_first=first,
                   loss_mid=mid)
    del ts, g0, scene, hist
    torch.cuda.empty_cache()

    # ---- converged scale: train steps on the dense scene, G=2 then G=1, with
    # one budget segment above the served demand (the steps move the scales) ----
    dstate = gm.update_3d_filter(
        gm.load_gaussian_ply(res["dpath"], sh_degree=3, capacity=res["dcap"], device=dev), cams)
    gt = torch.full((3, HEIGHT, WIDTH), 0.5, device=dev)
    bg = torch.zeros(3, device=dev)
    dts = TrainState(gaussians=dstate, iteration=ocfg.regularization_from_iter)
    dbudget = round_budget(res["dbudget"] + 1)
    del dstate
    torch.cuda.reset_peak_memory_stats()
    drows = []
    for g in (2, 2, 1, 1):
        step = make_train_step(mcfg, ocfg, replace(pcfg, max_per_tile=8192, tiles_per_block=g,
                                                   instance_budget=dbudget),
                               spatial_lr_scale=extent)
        events = []
        t0 = time.perf_counter()
        dts, met = step(dts, cams[0], gt, bg, 0, WIDTH, HEIGHT, events=events)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(int(met["n_overflow"]) == 0 and math.isfinite(float(met["loss"])),
              f"dense step: overflow {int(met['n_overflow'])}, loss {float(met['loss'])}")
        stages, _ = stage_medians([events])
        drows.append((g, wall, stages, int(met["n_instances"])))
    dpeak = torch.cuda.max_memory_allocated()
    launches = dict(blend.LAUNCHES)  # the training path ends here
    for g, wall, stages, n in drows:
        log(f"phase 6 dense train step G={g}: {wall:.3f} ms (host clock), "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" ms; {n} instances")
    log(f"phase 6 dense peak memory {dpeak / 2**30:.3f} GiB; training path kernel launches "
        f"{launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel never ran on the training path: "
          f"{launches}")

    # ---- the backward kernel alone at the dense view 0 (not counted) ----
    with torch.no_grad():
        prep = prepare(dts.gaussians, cams[0], 0.1)
        binning = bin_prep(prep, WIDTH, HEIGHT, dbudget, 8192, need_tile_gauss=False)
        inputs = blend_inputs(prep)
        fwd = blend.blend_forward(binning, inputs, WIDTH, HEIGHT)
        cot = random_cotangents(fwd, 13)
        dms = {}
        for g in (2, 1, 1, 2):
            dms.setdefault(g, []).append(time_ms(
                lambda g=g: blend.blend_backward(binning, inputs, fwd, cot, WIDTH, HEIGHT,
                                                 tiles_per_block=g), 3))
    log(f"phase 6 backward kernel alone at the dense view 0 ({binning.gauss_id.numel()} "
        f"instances; ms, turns G2,G1,G1,G2): G=1 {dms[1]}, G=2 {dms[2]}")
    results.update(launches=launches, dense_rows=drows, dense_peak=dpeak, dense_bwd_ms=dms)
    return results


def profile_serving(workdir):
    """``--profile``: torch.profiler over 3 views of the 100k scene and 1 of
    the dense scene; prints the device time by operation and the device's
    busy share of the window, and writes Chrome traces into ``workdir``'s
    parent (build/chip_smoke/)."""
    from torch.profiler import ProfilerActivity, profile

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.renderer import render

    dev = torch.device(DEVICE)
    cams = orbit_cameras(N_VIEWS, dev)
    out_dir = os.path.dirname(workdir)
    for scene, views, max_per_tile in (("100k", 3, 512), ("dense", 1, 8192)):
        path = os.path.join(workdir, f"{scene}.ply")
        cap = scene_ply(path, scene)
        state = gm.update_3d_filter(
            gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
        budget = default_instance_budget(cap)
        with torch.no_grad():
            for cam in cams[:2]:  # warm-up, and the budget from the demand
                b = render(state, cam, [0, 0, 0], kernel_size=0.1, max_per_tile=max_per_tile,
                           instance_budget=budget, device=DEVICE)["binning"]
                if int(b.n_overflow):
                    budget = round_budget(int(b.n_instances))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for cam in cams[:views]:
                    render(state, cam, [0, 0, 0], kernel_size=0.1, max_per_tile=max_per_tile,
                           instance_budget=budget, device=DEVICE)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        ka = prof.key_averages()
        kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        n_ops = sum(e.count for e in ka if e.key.startswith("aten::"))
        log(f"profile {scene}: {views} views in {window_us / 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms ({100 * busy_us / window_us:.1f}% of the window); "
            f"per view {sum(e.count for e in kernels) / views:.0f} kernels from "
            f"{n_ops / views:.0f} aten ops")
        log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
        prof.export_chrome_trace(os.path.join(out_dir, f"profile_{scene}.json"))
        del state
        torch.cuda.empty_cache()


def profile_training(workdir):
    """``--profile``: torch.profiler over iterations 21-25 of ``train`` on the
    100k scene (after the work-buffer autotune has settled, before any
    densify); prints the device time by operation and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from radegs_torch.ops.binning import default_instance_budget
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import train

    cams = orbit_cameras(N_VIEWS, torch.device(DEVICE))
    path = os.path.join(workdir, "train100k.ply")
    cap = scene_ply(path, "100k")
    scene, g0, _ = training_scene(path, cap, cams, default_instance_budget(cap))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def around(it, ts, m):
        if it == 20:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif it == 25:
            torch.cuda.synchronize()
            window["us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.stop()

    train(scene, g0, ModelConfig(kernel_size=0.1),
          OptimizationConfig(iterations=25, densify_from_iter=100, regularization_from_iter=10),
          PipelineConfig(max_per_tile=512), log_every=25, device=DEVICE, callbacks=[around])
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile training 100k: iterations 21-25 in {window['us'] / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / window['us']:.1f}% of the window); per "
        f"iteration {sum(e.count for e in kernels) / 5:.0f} kernels from "
        f"{sum(e.count for e in ka if e.key.startswith('aten::')) / 5:.0f} aten ops")
    log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    prof.export_chrome_trace(os.path.join(os.path.dirname(workdir), "profile_train.json"))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "radegs_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository (radegs_torch/ missing)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = setup()
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    if sys.argv[1:] == ["--profile"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            profile_serving(tmp)
            profile_training(tmp)
        return
    parity = [parity_scene(), parity_scene(250, 190, (1.6, 0, 0))]
    err2 = max(p[0] for p in parity)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        res = full_scale(tmp)
        tr = training(res)
    kernels = []
    for g, replaces in ((1, "radegs_tpu/ops/pallas_blend.py:263"),
                        (2, "radegs_tpu/ops/pallas_blend_mt.py:73")):
        kernels.append({
            "name": f"blend_fwd[G={g}]", "route": "cuda",
            "source": "radegs_torch/csrc/blend_fwd.cu", "replaces": replaces,
            "launches": res["launches"][f"blend_fwd[G={g}]"],
            "max_abs_err": max(err2, res["err"]),
            "ms": float(np.median(res["timing"][g])), "plain_ms": res["plain_ms"],
            "bound_ms": res["bound"], "bound_by": res["bound_by"], "library_ms": None,
        })
    for g, replaces in ((1, "radegs_tpu/ops/pallas_blend.py:600"),
                        (2, "radegs_tpu/ops/pallas_blend_mt.py:357")):
        kernels.append({
            "name": f"blend_bwd[G={g}]", "route": "cuda",
            "source": "radegs_torch/csrc/blend_bwd.cu", "replaces": replaces,
            "launches": tr["launches"][f"blend_bwd[G={g}]"],
            "max_abs_err": max([p[1] for p in parity] + [res["bwd_abs"]]),
            "ms": float(np.median(res["btiming"][g])), "plain_ms": res["bplain_ms"],
            "bound_ms": res["bbound"], "bound_by": res["bbound_by"], "library_ms": None,
        })
    log(f"backward kernel vs plain, max rel err per field over phases 2 and 5: "
        f"{max([p[2] for p in parity] + [res['bwd_rel']]):.3e}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
