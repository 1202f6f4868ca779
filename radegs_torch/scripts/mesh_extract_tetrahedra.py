"""Marching-Tetrahedra mesh extraction of a trained model (port of
``scripts/mesh_extract_tetrahedra.py``; the reference
mesh_extract_tetrahedra.py) to ``<model>/recon.ply``. ``--iteration``
(default 30000) falls back to the latest saved iteration when that one was
not saved. ``--max_per_tile`` defaults to 1024 here (the JAX script adds the
flag a second time with that default, which argparse refuses).

    python -m radegs_torch.scripts.mesh_extract_tetrahedra -m <model>
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    """Returns (vertices, faces) of ``recon.ply``."""
    from radegs_torch.data.scene import Scene, search_max_iteration
    from radegs_torch.mesh.extract_tetra import extract_mesh_tetrahedra
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train.arguments import add_group, extract, get_combined_args
    from radegs_torch.train.config import ModelConfig, PipelineConfig
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="Marching-Tetrahedra mesh extraction")
    add_group(p, ModelConfig, "ModelParams")
    add_group(p, PipelineConfig, "PipelineParams")
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--binary_steps", type=int, default=8)
    p.set_defaults(max_per_tile=1024)
    add_device_arg(p)
    args = get_combined_args(p, argv)
    dev = resolve_device(args.device)
    mcfg = extract(ModelConfig, args)

    pc_dir = os.path.join(mcfg.model_path, "point_cloud")
    iteration = (args.iteration
                 if os.path.isdir(os.path.join(pc_dir, f"iteration_{args.iteration}"))
                 else search_max_iteration(pc_dir))
    state = gm.load_gaussian_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        sh_degree=mcfg.sh_degree, device=dev)
    print(f"loaded gaussians from iteration {iteration}")
    scene = Scene(mcfg.source_path, model_path=None, images=mcfg.images, eval_split=False,
                  white_background=mcfg.white_background, resolution=mcfg.resolution,
                  shuffle=False, device=dev)
    bg = torch.full((3,), 1.0 if mcfg.white_background else 0.0, device=dev)
    return extract_mesh_tetrahedra(
        state, scene.getTrainCameras(), mcfg.kernel_size, bg,
        out_path=os.path.join(mcfg.model_path, "recon.ply"), n_binary_steps=args.binary_steps,
        max_per_tile=args.max_per_tile, device=dev)


if __name__ == "__main__":
    main()
