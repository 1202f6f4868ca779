"""Tanks and Temples F-score (port of ``scripts/eval_tnt.py``; the
reference's eval_tnt/run.py protocol): trajectory alignment, the
three-stage ICP, the crop volume and precision / recall / F1 at tau, with
the curves and scalars written to ``--out_dir``.

    python -m radegs_torch.scripts.eval_tnt --dataset_dir <gt dir> \
        --traj_path <estimate .log> --ply_path <reconstruction .ply> [--tau 0.01]

``<gt dir>`` holds ``<scene>.ply`` (the ground-truth cloud),
``<scene>_COLMAP_SfM.log`` and optionally ``<scene>.json`` (the crop).
``--tau`` defaults to the scene's published threshold (``SCENE_TAU``, 0.01
for another scene). Numpy + scipy on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    """Returns (the result dict of ``evaluate_tnt``, its stage stats)."""
    from radegs_torch.eval.tnt import evaluate_tnt, read_trajectory_log
    from radegs_torch.utils import ply as plyio

    p = argparse.ArgumentParser(description="radegs_torch Tanks and Temples F-score")
    p.add_argument("--dataset_dir", type=str, required=True,
                   help="dir with <scene>.ply GT, <scene>_COLMAP_SfM.log, <scene>.json crop")
    p.add_argument("--traj_path", type=str, required=True, help="estimated trajectory .log")
    p.add_argument("--ply_path", type=str, required=True, help="reconstruction .ply")
    p.add_argument("--scene", type=str, default=None)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--tau", type=float, default=None,
                   help="distance threshold (default: the scene's published one)")
    args = p.parse_args(argv)

    scene = args.scene or os.path.basename(args.dataset_dir.rstrip("/"))
    est_pts, _, _ = plyio.read_point_cloud(args.ply_path)
    gt_pts, _, _ = plyio.read_point_cloud(os.path.join(args.dataset_dir, f"{scene}.ply"))
    gt_traj = read_trajectory_log(os.path.join(args.dataset_dir, f"{scene}_COLMAP_SfM.log"))
    est_traj = read_trajectory_log(args.traj_path)
    crop = os.path.join(args.dataset_dir, f"{scene}.json")
    stats = {}
    r = evaluate_tnt(
        scene, est_pts.astype(np.float64), gt_pts.astype(np.float64),
        est_traj=est_traj, gt_traj=gt_traj,
        crop_json=crop if os.path.exists(crop) else None, tau=args.tau,
        out_dir=args.out_dir, stats=stats,
    )
    print(f"precision {r['precision']:.4f}  recall {r['recall']:.4f}  F1 {r['f1']:.4f}")
    print(f"stages: registration {stats['registration_s']:.3f} s, crop and downsample "
          f"{stats['downsample_s']:.3f} s, histogram queries {stats['histo_s']:.3f} s")
    return r, stats


if __name__ == "__main__":
    main()
