"""Tetra seed-decimation quality sweep (port of ``scripts/decimation_sweep.py``).

Extracts the marching-tetrahedra mesh of an on-surface splat cloud (the
``quality_dense`` analytic sphere + plane scene, noise 0: closed-form
chamfer ground truth, no training in the loop) at several seed-decimation
settings and reports the kept seeds' mesh x chamfer x wall-clock: the seed
decimation chosen for Delaunay time is scored on mesh quality.

Reference seed density being decimated: 8 box corners at 3 sigma + the
centre per Gaussian (scene/gaussian_model.py:399-429).

    python -m radegs_torch.scripts.decimation_sweep              # 40k points, 400x300
    python -m radegs_torch.scripts.decimation_sweep --n_points 600000 --width 1600 \
        --height 1200 --settings 1.0 auto 3.0 --report decim_sweep.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None, stats=None):
    """Run the sweep and write its report; returns the report. ``stats``: a
    dict that receives each setting's extractor stats (``stats=``)."""
    from radegs_torch.utils.device import add_device_arg, resolve_device

    ap = argparse.ArgumentParser(description="radegs_torch tetra seed-decimation sweep")
    ap.add_argument("--n_points", type=int, default=40_000)
    ap.add_argument("--n_views", type=int, default=6)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--settings", nargs="+", default=None,
                    help="decimation voxel settings: 'full', 'auto' (the extractor's own) or "
                         "multiples of the median splat sigma like '1.0' '3.0'")
    ap.add_argument("--report", type=str, default="decimation_sweep.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from radegs_torch.mesh.extract_tetra import extract_mesh_tetrahedra
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.scripts import synthetic
    from radegs_torch.scripts.quality_dense import mesh_chamfer
    from radegs_torch.scripts.soak_dense import opaque_params, orbit_cameras

    rng = np.random.default_rng(0)
    pts = synthetic.surface_points(args.n_points, rng, noise=0.0)
    cols = rng.uniform(0.1, 0.9, size=(args.n_points, 3)).astype(np.float32)
    cams = orbit_cameras(args.n_views, args.width, args.height, device=dev)
    state = gm.create_from_points(pts, cols, capacity=gm.round_capacity(args.n_points),
                                  device=dev)
    state = gm.update_3d_filter(state, cams)
    state = state.replace(params=opaque_params(state))
    bg = torch.zeros(3, device=dev)
    views = [(c, None, i) for i, c in enumerate(cams)]

    # seed half-extents are 3 sigma_max per axis. The sweep's voxels are
    # k x the median sigma of the raw scales; the extractor's 'auto' voxel
    # is one median sigma of the Mip-filtered scales (mesh/extract_tetra.py).
    scale3_med = float(np.median(
        torch.exp(state.params.scaling).max(dim=1).values[state.active].cpu().numpy()))
    sigma_med = scale3_med / 3.0
    settings = args.settings or ["full", "1.0", "auto", "3.0"]

    results = []
    report = {}
    for s in settings:
        if s == "full":
            dec = None
        elif s == "auto":
            dec = "auto"
        else:
            dec = float(s) * sigma_med
        st = {}
        t0 = time.time()
        verts, faces = extract_mesh_tetrahedra(state, views, kernel_size=0.1, bg=bg,
                                               decimate=dec, out_path=None, device=dev,
                                               stats=st)
        wall = time.time() - t0
        if stats is not None:
            stats[s] = st
        score = mesh_chamfer(verts, faces, np.random.default_rng(7))
        rec = {"setting": s, "decimate_voxel": dec if dec else 0.0,
               "wall_s": round(wall, 1), "verts": int(len(verts)),
               **{k: round(v, 6) if isinstance(v, float) else v for k, v in score.items()}}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        report = {"n_points": args.n_points, "resolution": [args.width, args.height],
                  "n_views": args.n_views, "sigma_median": sigma_med, "results": results}
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(f"report -> {args.report}", flush=True)
    return report


if __name__ == "__main__":
    main()
