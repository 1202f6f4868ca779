"""TSDF mesh extraction of a trained model (port of
``scripts/mesh_extract.py``; the reference mesh_extract.py): the train views
rendered over a white background (mesh_extract.py:44), fused into a TSDF
and meshed to ``<model>/recon.ply``; ``--unbounded`` instead extracts in
contracted space (utils/mesh_utils.py:163-270); ``--cluster_to_keep N``
also writes ``recon_post.ply`` with the N largest clusters.

    python -m radegs_torch.scripts.mesh_extract -m <model> [--voxel_size 0.004]
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    """Returns (vertices, faces) of ``recon.ply``."""
    from radegs_torch.data.scene import Scene, search_max_iteration
    from radegs_torch.mesh.tsdf import extract_mesh_tsdf
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train.arguments import add_group, extract, get_combined_args
    from radegs_torch.train.config import ModelConfig, PipelineConfig
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="TSDF mesh extraction")
    add_group(p, ModelConfig, "ModelParams")
    add_group(p, PipelineConfig, "PipelineParams")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--voxel_size", type=float, default=0.002)
    p.add_argument("--max_resolution", type=int, default=768)
    p.add_argument("--unbounded", action="store_true",
                   help="Mip-360-style contracted-space extraction (utils/mesh_utils.py:"
                        "163-270) instead of bounded TSDF fusion")
    p.add_argument("--mesh_res", type=int, default=512,
                   help="contracted-grid resolution for --unbounded")
    p.add_argument("--cluster_to_keep", type=int, default=0,
                   help="if > 0, post-process the mesh down to the N largest connected "
                        "clusters (mesh_utils.py:23-44)")
    add_device_arg(p)
    args = get_combined_args(p, argv)
    dev = resolve_device(args.device)
    mcfg = extract(ModelConfig, args)

    pc_dir = os.path.join(mcfg.model_path, "point_cloud")
    iteration = args.iteration if args.iteration > 0 else search_max_iteration(pc_dir)
    state = gm.load_gaussian_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        sh_degree=mcfg.sh_degree, device=dev)
    print(f"loaded gaussians from iteration {iteration}")
    scene = Scene(mcfg.source_path, model_path=None, images=mcfg.images, eval_split=False,
                  white_background=mcfg.white_background, resolution=mcfg.resolution,
                  shuffle=False, device=dev)
    bg = torch.ones(3, device=dev)  # white, as the reference extracts
    out_path = os.path.join(mcfg.model_path, "recon.ply")
    if args.unbounded:
        from radegs_torch.mesh.unbounded import extract_mesh_unbounded

        verts, faces, _ = extract_mesh_unbounded(
            state, scene.getTrainCameras(), mcfg.kernel_size, bg, resolution=args.mesh_res,
            out_path=out_path, device=dev)
    else:
        verts, faces = extract_mesh_tsdf(
            state, scene.getTrainCameras(), mcfg.kernel_size, bg, voxel_size=args.voxel_size,
            max_resolution=args.max_resolution, out_path=out_path, device=dev)
    print(f"wrote {out_path}: {len(verts)} vertices, {len(faces)} faces")
    if args.cluster_to_keep > 0:
        from radegs_torch.mesh.culling import post_process_mesh
        from radegs_torch.utils.ply import write_mesh

        pv, pf = post_process_mesh(verts, faces, cluster_to_keep=args.cluster_to_keep)
        post_path = out_path.replace(".ply", "_post.ply")
        write_mesh(post_path, pv, pf)
        print(f"post-processed {len(faces)} -> {len(pf)} faces: {post_path}")
    return verts, faces


if __name__ == "__main__":
    main()
