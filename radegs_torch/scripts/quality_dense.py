"""Quality at schedule on the closed-form scene (port of
``scripts/quality_dense.py``).

Mirrors the reference's in-train evaluation protocol (train.py:246-270:
held-out PSNR at fixed eval iterations) plus the DTU mesh evaluation
(dtu_eval/eval.py:120-167), on the dense synthetic scene whose ground
truth is CLOSED-FORM, so mesh accuracy needs no captured dataset:

- Scene: ``synthetic.surface_points`` with ``noise=0``: a |x| = 1.3 sphere
  and a y = -1.4 plane patch (|x|, |z| <= 3). Distance to the surface union
  is analytic, so "accuracy" (mesh -> surface) is exact, and
  "completeness" (surface -> mesh) samples the analytic surface directly.
- GT images: renders of an opaque splat cloud sitting exactly ON the
  surface. The TRAINING state starts from a jittered copy (sigma 0.02 off
  the surface): optimisation must pull splats back onto the surface for
  the extracted mesh to score.
- Held-out eval: every ``eval_every``-th orbit view is excluded from
  training; PSNR on those is logged at the eval iterations.
- Mesh eval: both extractors (TSDF + Marching Tetrahedra), each scored
  accuracy / completeness / overall a la DTU (mean distances, ``max_dist``
  outlier cap), with mesh samples from ``eval.dtu.sample_mesh_surface``.

    python -m radegs_torch.scripts.quality_dense --iters 30000 \
        --eval_iters 1000 7000 15000 30000 --n_views 40 --eval_every 5 \
        --checkpoint q30k.pt --wall_budget 3000 --report quality.json
    python -m radegs_torch.scripts.quality_dense --n_points 2000 --width 64 \
        --height 48 --n_views 8 --iters 20 --eval_iters 1 10 20 --skip_mesh --device cpu

The report has the JAX script's fields, less its XLA compile counts, plus
``device`` (the card's name and power limit, peak allocated bytes) and each
extractor's stage seconds (``stats``). ``health.overflow_events`` counts the
training log points whose step dropped work and the evaluation renders
that dropped work at the caps (``render`` grows its budget to each view's
demand first).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

PLANE_Y = -1.4
PLANE_HALF = 3.0
SPHERE_R = 1.3


def analytic_distance(p):
    """Exact unsigned distance from points (N,3) to the scene surface
    (sphere |x| = R  union  finite plane patch y = PLANE_Y, |x|,|z| <= 3)."""
    d_sphere = np.abs(np.linalg.norm(p, axis=1) - SPHERE_R)
    dx = np.maximum(np.abs(p[:, 0]) - PLANE_HALF, 0.0)
    dz = np.maximum(np.abs(p[:, 2]) - PLANE_HALF, 0.0)
    dy = p[:, 1] - PLANE_Y
    d_plane = np.sqrt(dx * dx + dy * dy + dz * dz)
    return np.minimum(d_sphere, d_plane)


def sample_analytic_surface(n, rng):
    """Uniform samples of the OBSERVED analytic surface (visibility proxy:
    the orbit cameras see the whole sphere above y = -1.25 and the plane
    outside the sphere's shadow ring and inside the frustum-covered area)."""
    # sphere: area-uniform directions, keep y above the near-plane ring
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sph = d[d[:, 1] > -1.25 / SPHERE_R] * SPHERE_R
    # plane: uniform in the annulus 1.6 < r_xz, |x|,|z| < 2.7
    m = rng.uniform(-2.7, 2.7, size=(n, 2))
    r = np.hypot(m[:, 0], m[:, 1])
    m = m[r > 1.6]
    pl = np.stack([m[:, 0], np.full(len(m), PLANE_Y), m[:, 1]], axis=1)
    return np.concatenate([sph, pl]).astype(np.float32)


def mesh_chamfer(verts, faces, rng, max_dist=0.5, sample_thresh=0.02):
    """DTU-style two-sided score vs the analytic surface."""
    from scipy.spatial import cKDTree

    from radegs_torch.eval.dtu import sample_mesh_surface

    mesh_pts = sample_mesh_surface(
        np.asarray(verts, np.float64), np.asarray(faces), sample_thresh
    ).astype(np.float32)
    # accuracy: mesh -> surface, exact
    d2s = analytic_distance(mesh_pts)
    acc = float(d2s[d2s < max_dist].mean())
    # completeness: surface -> mesh samples
    surf = sample_analytic_surface(200_000, rng)
    s2d, _ = cKDTree(mesh_pts).query(surf, workers=-1)
    comp = float(s2d[s2d < max_dist].mean())
    return {
        "accuracy_mean": acc,
        "completeness_mean": comp,
        "overall": (acc + comp) / 2,
        "accuracy_median": float(np.median(d2s)),
        "completeness_median": float(np.median(s2d)),
        "outlier_frac_acc": float((d2s >= max_dist).mean()),
        "mesh_samples": int(mesh_pts.shape[0]),
    }


def main(argv=None, step_events=None):
    """Run the protocol and write its report; returns the report.
    ``step_events``: passed to ``train`` (CUDA-event marks of each step)."""
    from radegs_torch.utils.device import add_device_arg, resolve_device

    ap = argparse.ArgumentParser(description="radegs_torch quality at schedule")
    ap.add_argument("--iters", type=int, default=7000)
    ap.add_argument("--eval_iters", nargs="+", type=int, default=[1000, 3000, 7000])
    ap.add_argument("--n_views", type=int, default=16)
    ap.add_argument("--eval_every", type=int, default=4,
                    help="every k-th orbit view is held out for eval")
    ap.add_argument("--n_points", type=int, default=600_000)
    ap.add_argument("--report", type=str, default="quality_dense.json")
    ap.add_argument("--densify_until", type=int, default=None)
    ap.add_argument("--skip_mesh", action="store_true")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint file: saved at each eval iteration and at a wall "
                         "budget cut, resumed from when it exists")
    ap.add_argument("--width", type=int, default=None,
                    help="override the protocol 1600x1200 (CPU smoke runs)")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--wall_budget", type=float, default=None,
                    help="training wall-clock budget in seconds: past it the loop stops "
                         "after an eval (and a checkpoint), and the report says partial")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops.ssim import psnr
    from radegs_torch.scripts import synthetic
    from radegs_torch.scripts.soak_dense import (
        device_fields,
        opaque_params,
        orbit_cameras,
        render_clipped,
        render_views,
    )
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import SceneLike, StopTraining, init_train_state, train
    from radegs_torch.utils.checkpoint import (
        checkpoint_capacity,
        load_checkpoint,
        save_checkpoint,
    )

    W = args.width or synthetic.WIDTH
    H = args.height or synthetic.HEIGHT
    rng = np.random.default_rng(0)
    pts = synthetic.surface_points(args.n_points, rng, noise=0.0)
    cols = rng.uniform(0.1, 0.9, size=(args.n_points, 3)).astype(np.float32)
    cams = orbit_cameras(args.n_views, W, H, device=dev)
    health = {"overflow_events": 0, "overflow_instances": 0.0, "nan_events": 0}

    # GT state: splats ON the surface, opaque
    gt_state = gm.create_from_points(pts, cols, capacity=gm.round_capacity(args.n_points),
                                     device=dev)
    gt_state = gm.update_3d_filter(gt_state, cams)
    gt_state = gt_state.replace(params=opaque_params(gt_state))
    bg = torch.zeros(3, device=dev)
    print("rendering ground-truth views...", flush=True)
    views = render_views(gt_state, cams, bg, health)
    del gt_state
    train_views = [v for i, v in enumerate(views) if i % args.eval_every]
    test_views = [v for i, v in enumerate(views) if not i % args.eval_every]
    print(f"{len(train_views)} train / {len(test_views)} test views", flush=True)

    # training state: jittered OFF the surface; the schedule must pull it
    # back for the mesh to score
    state = gm.create_from_points(
        pts + 0.02 * rng.normal(size=pts.shape).astype(np.float32),
        cols, capacity=gm.round_capacity(args.n_points), device=dev)
    state = gm.update_3d_filter(state, cams)

    mcfg = ModelConfig(kernel_size=0.1)
    ocfg = OptimizationConfig(
        iterations=args.iters,
        regularization_from_iter=min(15000, args.iters // 2),
        densify_until_iter=args.densify_until or min(15000, int(args.iters * 0.8)),
    )
    pcfg = PipelineConfig(max_per_tile=1024)

    eval_at = sorted(set(min(e, args.iters) for e in args.eval_iters))
    eval_log = []
    stamps = []

    # incremental report: a run cut from outside still leaves an artifact
    report = {
        "protocol": "quality_dense analytic-surface (sphere+plane)",
        "iters": args.iters,
        "resolution": [W, H],
        "partial": True,
        "eval": eval_log,
        "health": health,
    }

    def phase_rates():
        """it/s per 1000-iteration bucket (the sustained rate per schedule
        phase: densify ramp, post-densify, regularised tail)."""
        out = {}
        for b in range(0, args.iters, 1000):
            seg = [s for s in stamps if b <= s[0] < b + 1000]
            if len(seg) >= 2:
                out[f"{b}-{b + 1000}"] = round(
                    (seg[-1][0] - seg[0][0]) / (seg[-1][1] - seg[0][1]), 3)
        return out

    def flush_report():
        report["it_per_s_by_1k"] = phase_rates()
        report["device"] = device_fields(dev)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)

    def view_psnr(g, cam, gt_img):
        img = render_clipped(g, cam, bg, mcfg.kernel_size, pcfg.max_per_tile, health)
        return float(psnr(img, gt_img))

    def eval_test(ts, it):
        ps = [view_psnr(ts.gaussians, cam, gt_img) for cam, gt_img, _ in test_views]
        # train-view PSNR on a strided subset (the reference samples strided
        # too, train.py: range(5, 30, 5)): the train/test gap separates
        # protocol overfit (few orbit views) from optimisation regressions
        stride = max(1, len(train_views) // len(test_views))
        pt = [view_psnr(ts.gaussians, cam, gt_img)
              for cam, gt_img, _ in train_views[::stride][:len(test_views)]]
        rec = {"iter": it, "psnr_test": float(np.mean(ps)),
               "psnr_train": float(np.mean(pt)),
               "psnr_per_view": ps,
               "n_active": int(ts.gaussians.n_active())}
        eval_log.append(rec)
        flush_report()
        print(f"[eval {it}] test psnr {rec['psnr_test']:.2f} "
              f"({rec['n_active']} splats)", flush=True)

    t_loop0 = time.perf_counter()
    stopped_at = {"it": None}

    def on_it(it, ts, m):
        if (args.wall_budget is not None and stopped_at["it"] is None
                and time.perf_counter() - t_loop0 > args.wall_budget):
            stopped_at["it"] = it
            eval_test(ts, it)
            if args.checkpoint:
                save_checkpoint(args.checkpoint, ts, it)
                print(f"[ckpt] saved at {it} (wall budget cut)", flush=True)
            print(f"[wall budget] stopping gracefully at iteration {it}", flush=True)
            raise StopTraining
        if m is not None:
            stamps.append((it, time.perf_counter()))
            print(f"[{it}] psnr {m['psnr']:.2f} loss {m['loss']:.4f} "
                  f"inst {m['n_instances']:.0f} pts {m['n_active']}", flush=True)
            if m["n_overflow"] > 0 or m["tile_overflow"] > 0:
                health["overflow_events"] += 1
                health["overflow_instances"] += float(m["n_overflow"])
            if not np.isfinite(m["loss"]):
                health["nan_events"] += 1
            if it % 500 == 0:
                flush_report()
        if it in eval_at:
            eval_test(ts, it)
            if args.checkpoint:
                save_checkpoint(args.checkpoint, ts, it)
                print(f"[ckpt] saved at {it}", flush=True)

    resume_state, start_it = None, 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        # the state grew while it trained: restore at the checkpoint's capacity
        resume_state, start_it = load_checkpoint(
            args.checkpoint, init_train_state(state),
            capacity=checkpoint_capacity(args.checkpoint))
        print(f"resumed from {args.checkpoint} at iteration {start_it}", flush=True)

    t0 = time.perf_counter()
    ts, _ = train(SceneLike(cameras=train_views, extent=4.5), state, mcfg, ocfg, pcfg,
                  log_every=100, callbacks=[on_it], resume_state=resume_state,
                  device=dev, step_events=step_events)
    t_train = time.perf_counter() - t0

    # checkpoint-recovery mode (resume iter == --iters): the loop body never
    # runs, so the callback eval never fires; produce the final eval here.
    # (A wall-budget stop already evaluated at its stop iteration.)
    if stopped_at["it"] is None and not any(e["iter"] >= args.iters for e in eval_log):
        eval_test(ts, args.iters)

    # checkpoint-recovery mode (the loop ran zero iterations): no training
    # rate was measured, t_train is set-up time only, so the rate fields
    # are null. The rates are host clock between log points; at each one
    # the metrics' float() waits for the card's stream.
    recovery_only = start_it >= args.iters
    no_rate = recovery_only or not stamps
    done_it = stopped_at["it"] or args.iters
    tail = [s for s in stamps if s[0] >= done_it * 3 // 4]
    if no_rate:
        sustained = None
        t_train = None
    elif len(tail) >= 2:
        sustained = (tail[-1][0] - tail[0][0]) / (tail[-1][1] - tail[0][1])
    else:
        sustained = done_it / t_train
    report = {
        "protocol": "quality_dense analytic-surface (sphere+plane)",
        "iters": args.iters,
        "iters_completed": done_it,
        "partial": stopped_at["it"] is not None,
        "train_views": len(train_views),
        "test_views": len(test_views),
        "resolution": [W, H],
        "recovered_from_checkpoint": recovery_only,
        "train_wall_s": t_train,
        "sustained_it_per_s": sustained,
        "it_per_s_by_1k": phase_rates(),
        "n_active_final": int(ts.gaussians.n_active()),
        "capacity_final": ts.gaussians.capacity,
        "health": health,
        "eval": eval_log,
    }

    if not args.skip_mesh:
        from radegs_torch.mesh.extract_tetra import extract_mesh_tetrahedra
        from radegs_torch.mesh.tsdf import extract_mesh_tsdf

        # STRIDED 8-view subset so fusion covers the whole orbit: a
        # consecutive prefix of a dense orbit sees only a fraction of the ring
        mviews = train_views[::max(1, len(train_views) // 8)][:8]
        mrng = np.random.default_rng(7)
        stem = os.path.splitext(args.report)[0]
        stats = {}
        t1 = time.perf_counter()
        v1, f1 = extract_mesh_tsdf(ts.gaussians, mviews, mcfg.kernel_size, bg,
                                   voxel_size=0.004, out_path=f"{stem}_tsdf.ply", device=dev,
                                   stats=stats)
        report["tsdf"] = {"wall_s": time.perf_counter() - t1, "verts": int(v1.shape[0]),
                          "faces": int(f1.shape[0]), **mesh_chamfer(v1, f1, mrng),
                          "stats": stats}
        print("tsdf:", json.dumps(report["tsdf"]), flush=True)

        stats = {}
        t2 = time.perf_counter()
        v2, f2 = extract_mesh_tetrahedra(ts.gaussians, mviews, mcfg.kernel_size, bg,
                                         out_path=f"{stem}_tetra.ply", device=dev,
                                         stats=stats)
        report["tetra"] = {"wall_s": time.perf_counter() - t2, "verts": int(v2.shape[0]),
                           "faces": int(f2.shape[0]), **mesh_chamfer(v2, f2, mrng),
                           "stats": stats}
        print("tetra:", json.dumps(report["tetra"]), flush=True)

    report["device"] = device_fields(dev)  # the peak memory includes the meshes
    print(json.dumps(report, indent=2))
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
