"""Cull a reconstructed mesh to the camera-observed region (port of
``scripts/cull_mesh.py``; the reference's eval_tnt/cull_mesh.py:385-418,
the pre-step some Tanks and Temples evaluations apply before the F-score).

Renders each view's mesh depth on the card (``mesh.culling``), keeps the
faces whose vertices >= ``--min-views`` cameras see, and writes
``<ply>_cull.ply``; ``--largest-component`` then keeps only the largest
connected component (the reference's get_connected_mesh).

    python -m radegs_torch.scripts.cull_mesh --traj-path traj.log --ply-path recon.ply \
        --width 1920 --height 1080 --fx 1163.87 --fy 1172.79 \
        [--cx ... --cy ...] [--largest-component] [--device cpu]

Trajectory formats: a TNT ``.log`` (``eval.tnt.read_trajectory_log``) or a
``.npy`` of (N, 4, 4) camera-to-world poses.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    """Returns the culled (vertices, faces)."""
    from radegs_torch.eval.tnt import read_trajectory_log
    from radegs_torch.mesh.culling import cull_mesh, keep_largest_component
    from radegs_torch.utils.device import add_device_arg, resolve_device
    from radegs_torch.utils.ply import read_mesh, write_mesh

    ap = argparse.ArgumentParser(description="radegs_torch mesh culling")
    ap.add_argument("--traj-path", required=True,
                    help=".log (TNT) or .npy of (N,4,4) c2w poses")
    ap.add_argument("--ply-path", required=True)
    ap.add_argument("--out", default=None,
                    help="default: <ply-path minus .ply>_cull.ply")
    # TanksandTemples defaults (cull_mesh.py:406-411)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--fx", type=float, default=1163.8678928442187)
    ap.add_argument("--fy", type=float, default=1172.793101201448)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--eps", type=float, default=0.005)
    ap.add_argument("--min-views", type=int, default=20)
    ap.add_argument("--largest-component", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cx = args.cx if args.cx is not None else args.width / 2.0
    cy = args.cy if args.cy is not None else args.height / 2.0
    c2w = np.load(args.traj_path) if args.traj_path.endswith(".npy") else \
        read_trajectory_log(args.traj_path)
    cams = []
    for m in np.asarray(c2w, np.float64):
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], axis=0)
        w2c = np.linalg.inv(m).astype(np.float32)
        cams.append((w2c, args.fx, args.fy, cx, cy, args.width, args.height))
    print(f"{len(cams)} cameras from {args.traj_path}", flush=True)

    verts, faces = read_mesh(args.ply_path)
    print(f"mesh: {len(verts)} verts, {len(faces)} faces", flush=True)

    t0 = time.perf_counter()
    cv, cf = cull_mesh(verts, faces, cams, eps=args.eps, min_views=args.min_views, device=dev)
    print(f"culled -> {len(cv)} verts, {len(cf)} faces ({time.perf_counter() - t0:.3f} s)",
          flush=True)
    if args.largest_component:
        cv, cf = keep_largest_component(cv, cf)
        print(f"largest component -> {len(cv)} verts, {len(cf)} faces", flush=True)

    out = args.out or args.ply_path.replace(".ply", "") + "_cull.ply"
    write_mesh(out, np.asarray(cv), np.asarray(cf))
    print(f"saved {out}", flush=True)
    return cv, cf


if __name__ == "__main__":
    main()
