"""Batch rendering of a trained model (port of ``scripts/render.py``; the
reference render.py:24-65): train / test views to
``<model>/{train,test}/ours_<iter>/{renders,gt}/*.png``, with
``--save_depth`` the normalised median depth and the normal map beside each
render, with ``--path_frames N`` an N-frame ellipse orbit to
``<model>/video_<iter>/``. PNGs are written without PIL.

    python -m radegs_torch.scripts.render -m <model> [--save_depth] [--path_frames 120]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def save_png(path, arr_chw):
    """(C, H, W) or (H, W) values in [0, 1] -> 8-bit PNG (rounded)."""
    from radegs_torch.utils.image import write_png

    arr = arr_chw.detach().cpu().numpy() if torch.is_tensor(arr_chw) else np.asarray(arr_chw)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    write_png(path, (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).squeeze())


@torch.no_grad()
def render_set(model_path, name, iteration, views, state, bg, mcfg, pcfg, save_depth=False):
    from radegs_torch.renderer import render

    t0 = time.perf_counter()
    base = os.path.join(model_path, name, f"ours_{iteration}")
    rdir, gdir = os.path.join(base, "renders"), os.path.join(base, "gt")
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(gdir, exist_ok=True)
    for idx, (cam, gt, _) in enumerate(views):
        out = render(state, cam, bg, kernel_size=mcfg.kernel_size,
                     max_per_tile=pcfg.max_per_tile, tiles_per_block=pcfg.tiles_per_block,
                     device=state.device)
        save_png(os.path.join(rdir, f"{idx:05d}.png"), out["render"])
        save_png(os.path.join(gdir, f"{idx:05d}.png"), gt)
        if save_depth:
            d = out["median_depth"][0]
            save_png(os.path.join(rdir, f"{idx:05d}_depth.png"),
                     (d / max(float(d.max()), 1e-9))[None])
            save_png(os.path.join(rdir, f"{idx:05d}_normal.png"), out["normal"] * 0.5 + 0.5)
    print(f"{name}: wrote {len(views)} renders to {base} in {time.perf_counter() - t0:.3f} s")
    return base


def main(argv=None):
    from radegs_torch.data.scene import Scene, search_max_iteration
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train.arguments import add_group, extract, get_combined_args
    from radegs_torch.train.config import ModelConfig, PipelineConfig
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="radegs_torch rendering")
    add_group(p, ModelConfig, "ModelParams")
    add_group(p, PipelineConfig, "PipelineParams")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--save_depth", action="store_true")
    p.add_argument("--path_frames", type=int, default=0,
                   help="also render an N-frame ellipse orbit (video frames)")
    add_device_arg(p)
    args = get_combined_args(p, argv)
    dev = resolve_device(args.device)
    mcfg = extract(ModelConfig, args)
    pcfg = extract(PipelineConfig, args)

    pc_dir = os.path.join(mcfg.model_path, "point_cloud")
    iteration = args.iteration if args.iteration > 0 else search_max_iteration(pc_dir)
    state = gm.load_gaussian_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        sh_degree=mcfg.sh_degree, device=dev)
    scene = Scene(mcfg.source_path, model_path=None, images=mcfg.images, eval_split=mcfg.eval,
                  white_background=mcfg.white_background, resolution=mcfg.resolution,
                  shuffle=False, device=dev)
    bg = torch.full((3,), 1.0 if mcfg.white_background else 0.0, device=dev)

    if not args.skip_train:
        render_set(mcfg.model_path, "train", iteration, scene.getTrainCameras(), state, bg,
                   mcfg, pcfg, args.save_depth)
    if not args.skip_test and scene.getTestCameras():
        render_set(mcfg.model_path, "test", iteration, scene.getTestCameras(), state, bg, mcfg,
                   pcfg, args.save_depth)
    if args.path_frames > 0:
        from radegs_torch.utils.trajectories import ellipse_path, render_path

        path = ellipse_path([c for c, _, _ in scene.getTrainCameras()], n_frames=args.path_frames)
        t0 = time.perf_counter()
        out = render_path(state, path, bg, os.path.join(mcfg.model_path, f"video_{iteration}"),
                          kernel_size=mcfg.kernel_size, max_per_tile=pcfg.max_per_tile,
                          save_depth=args.save_depth)
        print(f"wrote {args.path_frames} orbit frames to {out} in "
              f"{time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
