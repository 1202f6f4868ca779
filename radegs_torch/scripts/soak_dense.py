"""Soak at realistic scale (port of ``scripts/soak_dense.py``): train on the
dense surface scene at 1600x1200 with the full reference schedule
(densification, opacity resets, capacity growth), report the sustained it/s
and rays/s at the GROWN capacity, then optionally time mesh extraction.

    python -m radegs_torch.scripts.soak_dense --iters 3000 --report soak.json
    python -m radegs_torch.scripts.soak_dense --n_points 2000 --iters 20 --device cpu

The report carries the device it ran on (``device``: the card's name and
power limit as nvidia-smi gives them, and the peak of
``torch.cuda.max_memory_allocated``); rates from a CPU run are not card
rates.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def orbit_cameras(n, width, height, radius=4.5, elev=0.45, device=None):
    """``n`` views on a wavy orbit around the origin (fov 0.9 x 0.7)."""
    from radegs_torch.core.camera import Camera

    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = [radius * np.sin(a), elev + 0.4 * np.sin(2 * a), -radius * np.cos(a)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 0.9, 0.7, width, height,
                                   device=device))
    return cams


def device_fields(dev: torch.device) -> dict:
    """What a report's numbers were measured on: the torch device, and on a
    card its name, the nvidia-smi name and power limit line and the peak
    allocated bytes since the last ``reset_peak_memory_stats``."""
    if dev.type != "cuda":
        return {"type": dev.type, "name": None, "nvidia_smi": None,
                "max_memory_allocated": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = None
    return {"type": dev.type, "name": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
            "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev))}


def opaque_params(state, opacity=0.85):
    """The state's parameters with every active row at ``opacity``."""
    from radegs_torch.models import gaussian_model as gm

    logit = gm.inverse_sigmoid(torch.tensor(opacity, dtype=torch.float32))
    return state.params.replace(opacity=torch.where(
        state.active[:, None], logit.to(state.device), state.params.opacity))


def render_views(state, cams, bg, health=None):
    """Ground-truth views [(cam, clipped image, index)] rendered at
    ``max_per_tile`` 1024 with the budget grown to each view's demand;
    work still dropped at the caps counts in ``health``."""
    views = []
    for i, cam in enumerate(cams):
        views.append((cam, render_clipped(state, cam, bg, 0.1, 1024, health), i))
        print(f"  gt view {i + 1}/{len(cams)}", flush=True)
    return views


@torch.no_grad()
def render_clipped(state, cam, bg, kernel_size, max_per_tile, health=None):
    """``render(...)["render"]`` clipped to [0, 1]. ``render`` grows its
    budget to the view's demand, so what it still drops is dropped at the
    caps: that counts in ``health`` (overflow events and instances)."""
    from radegs_torch.renderer import render

    out = render(state, cam, bg, kernel_size=kernel_size, max_per_tile=max_per_tile,
                 device=state.device)
    if health is not None:
        b = out["binning"]
        n_ovf, t_ovf = float(b.n_overflow), float(b.tile_overflow)
        if n_ovf > 0 or t_ovf > 0:
            health["overflow_events"] += 1
            health["overflow_instances"] += n_ovf
    return torch.clamp(out["render"], 0, 1)


def main(argv=None):
    """Run the soak and write its report; returns the report."""
    from radegs_torch.utils.device import add_device_arg, resolve_device

    ap = argparse.ArgumentParser(description="radegs_torch dense soak")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--n_views", type=int, default=12)
    ap.add_argument("--n_points", type=int, default=600_000)
    ap.add_argument("--report", type=str, default="soak_dense.json")
    ap.add_argument("--mesh", action="store_true", help="extract meshes at the end")
    ap.add_argument("--densify_until", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.scripts import synthetic
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import SceneLike, train

    W, H = synthetic.WIDTH, synthetic.HEIGHT
    rng = np.random.default_rng(0)
    pts = synthetic.surface_points(args.n_points, rng)
    cols = rng.uniform(0.1, 0.9, size=(args.n_points, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=gm.round_capacity(args.n_points),
                                  device=dev)
    cams = orbit_cameras(args.n_views, W, H, device=dev)
    state = gm.update_3d_filter(state, cams)

    # ground truth: renders of a jittered, OPAQUE copy (converged scenes
    # have high-opacity surface splats; stable targets that force real
    # gradients + densification pressure). The jitter covers every row of
    # the capacity, as the JAX script draws it.
    jitter = 0.01 * rng.normal(size=(state.capacity, 3)).astype(np.float32)
    gt_state = state.replace(params=opaque_params(state).replace(
        xyz=state.params.xyz + torch.from_numpy(jitter).to(dev),
        f_dc=state.params.f_dc * 1.1))
    bg = torch.zeros(3, device=dev)
    print("rendering ground-truth views...", flush=True)
    views = render_views(gt_state, cams, bg)
    del gt_state

    mcfg = ModelConfig(kernel_size=0.1)
    ocfg = OptimizationConfig(
        iterations=args.iters,
        regularization_from_iter=min(15000, args.iters // 2),
        densify_until_iter=args.densify_until or min(15000, int(args.iters * 0.8)),
    )
    pcfg = PipelineConfig(max_per_tile=1024)

    stamps = []

    def on_it(it, ts, m):
        if m is not None:
            stamps.append((it, time.perf_counter(), m.get("psnr", 0.0),
                           m.get("n_instances", 0)))
            print(f"[{it}] psnr {m['psnr']:.2f} loss {m['loss']:.4f} "
                  f"inst {m['n_instances']:.0f}", flush=True)

    t0 = time.perf_counter()
    ts, _ = train(SceneLike(cameras=views, extent=4.5), state, mcfg, ocfg, pcfg,
                  log_every=100, callbacks=[on_it], device=dev)
    t_train = time.perf_counter() - t0

    n_active = int(ts.gaussians.n_active())
    # sustained it/s over the LAST quarter (grown capacity, steady state),
    # host clock between log points: at each one the metrics' float()
    # waits for the card's stream, so the stamps bound finished work
    tail = [s for s in stamps if s[0] >= args.iters * 3 // 4]
    if len(tail) >= 2:
        its = (tail[-1][0] - tail[0][0]) / (tail[-1][1] - tail[0][1])
    else:
        its = args.iters / t_train
    report = {
        "iters": args.iters,
        "n_views": args.n_views,
        "resolution": [W, H],
        "n_active_final": n_active,
        "capacity_final": ts.gaussians.capacity,
        "train_wall_s": t_train,
        "sustained_it_per_s": its,
        "sustained_rays_per_s": its * W * H,
        "final_psnr": float(stamps[-1][2]) if stamps else None,
        "final_instances": float(stamps[-1][3]) if stamps else None,
    }

    if args.mesh:
        from radegs_torch.mesh.extract_tetra import extract_mesh_tetrahedra
        from radegs_torch.mesh.tsdf import extract_mesh_tsdf

        stem = os.path.splitext(args.report)[0]
        t1 = time.perf_counter()
        verts, faces = extract_mesh_tsdf(ts.gaussians, views[:8], mcfg.kernel_size, bg,
                                         voxel_size=0.004, out_path=f"{stem}_tsdf.ply",
                                         device=dev)
        report["tsdf_8view_s"] = time.perf_counter() - t1
        report["tsdf_verts"] = int(verts.shape[0])

        t2 = time.perf_counter()
        verts2, faces2 = extract_mesh_tetrahedra(ts.gaussians, views[:8], mcfg.kernel_size, bg,
                                                 out_path=f"{stem}_tetra.ply", device=dev)
        report["tetra_8view_s"] = time.perf_counter() - t2
        report["tetra_verts"] = int(verts2.shape[0])

    report["device"] = device_fields(dev)
    print(json.dumps(report, indent=2))
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
