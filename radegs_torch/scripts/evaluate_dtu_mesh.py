"""DTU mesh preparation and evaluation (port of
``scripts/evaluate_dtu_mesh.py``; the reference's evaluate_dtu_mesh.py):
Procrustes-align the reconstruction to the DTU calibration frame by the
camera centres, cull it by the dataset's foreground masks where it has
them, then run the chamfer evaluation.

    python -m radegs_torch.scripts.evaluate_dtu_mesh -m <model> --DTU <DTU reference dir> \
        --scan_id 24 [--mesh <model>/recon.ply] [--downsample_density 0.2 ...] [--device cpu]

Writes ``<model>/culled_mesh.ply`` and ``<model>/dtu_eval/``. The dataset's
cameras are read through ``data.scene.Scene`` on ``--device``; the rest is
numpy + scipy on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_dtu_camera_centers(dtu_dir, scan):
    """Camera centres from the DTU calibration (evaluate_dtu_mesh.py:60-76:
    the ``Calibration/cal18/pos_*.txt`` projection matrices). ``scan`` is
    unused: DTU's calibration is shared by every scan."""
    cal = os.path.join(dtu_dir, "Calibration", "cal18")
    centers = []
    for i in range(1, 50):
        f = os.path.join(cal, f"pos_{i:03d}.txt")
        if not os.path.exists(f):
            break
        Pm = np.loadtxt(f)  # 3x4
        centers.append(-np.linalg.inv(Pm[:, :3]) @ Pm[:, 3])  # centre = -M^-1 p4
    return np.stack(centers)


def main(argv=None):
    """Returns (the 4x4 alignment transform, the result dict of
    ``evaluate_dtu``, its stage stats)."""
    from radegs_torch.data.scene import Scene
    from radegs_torch.eval.dtu import evaluate_dtu
    from radegs_torch.eval.dtu_mesh import align_and_cull
    from radegs_torch.scripts.eval_dtu import add_dtu_args, print_stages
    from radegs_torch.train.arguments import add_group, extract, get_combined_args
    from radegs_torch.train.config import ModelConfig
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="radegs_torch DTU mesh evaluation")
    add_group(p, ModelConfig, "ModelParams")
    p.add_argument("--DTU", type=str, required=True, help="DTU reference data dir")
    p.add_argument("--scan_id", type=int, required=True)
    p.add_argument("--mesh", type=str, default=None, help="default <model>/recon.ply")
    add_dtu_args(p)
    add_device_arg(p)
    args = get_combined_args(p, argv)
    mcfg = extract(ModelConfig, args)

    mesh_path = args.mesh or os.path.join(mcfg.model_path, "recon.ply")
    scene = Scene(mcfg.source_path, model_path=None, images=mcfg.images, eval_split=False,
                  resolution=mcfg.resolution, shuffle=False, device=resolve_device(args.device))
    cams = scene.getTrainCameras()
    masks = [ci.mask for ci in scene.info.train_cameras]
    if all(m is None for m in masks):
        masks = None
    centers = load_dtu_camera_centers(args.DTU, args.scan_id)[: len(cams)]
    out_path = os.path.join(mcfg.model_path, "culled_mesh.ply")
    _, _, T = align_and_cull(mesh_path, cams, centers, masks=masks, out_path=out_path)
    print(f"aligned + culled mesh -> {out_path}")
    stats = {}
    r = evaluate_dtu(out_path, args.scan_id, args.DTU,
                     out_dir=os.path.join(mcfg.model_path, "dtu_eval"),
                     downsample_density=args.downsample_density, patch_size=args.patch_size,
                     max_dist=args.max_dist, visualize_threshold=args.visualize_threshold,
                     stats=stats)
    print(r)
    print_stages(stats)
    return T, r, stats


if __name__ == "__main__":
    main()
