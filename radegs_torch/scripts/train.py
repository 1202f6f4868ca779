"""Training CLI (port of ``scripts/train.py``; the reference train.py:61-214):
the loss schedule, densification windows, opacity resets, 3D-filter
refreshes, test PSNR at ``--test_iterations``, PLY snapshots at
``--save_iterations``, checkpoints (``torch.save``) at
``--checkpoint_iterations``, resume with ``--start_checkpoint`` and
``history.json``.

    python -m radegs_torch.scripts.train -s <dataset> -m <out_dir> [--eval] [flags]
    python -m radegs_torch.scripts.train --synthetic --iterations 300   # no dataset
    ... --device cpu                                                    # on the CPU
    ... --ip 127.0.0.1 --port 6009                    # serve SIBR's remote viewer while training
    ... --multichip [--world_size N] [--dist_backend {nccl,gloo}]   # several ranks
    torchrun --nproc_per_node N -m radegs_torch.scripts.train --multichip ...

With ``--ip`` each iteration polls the network viewer (``viewer.NetworkGUI``):
a connected viewer gets one frame per iteration, rendered on the card at
its camera and scaling modifier, and after the last iteration frames until
it sends ``keep_alive`` false.

``--multichip`` trains on several ranks (``parallel/``: each holds a block
of the Gaussians and renders a band of every view). Under ``torchrun`` the
CLI joins its process group; otherwise it spawns ``--world_size`` ranks
(default: one per card; with ``--device cpu``, gloo ranks on the CPU, the
counterpart of the JAX CLI's ``--cpu_devices``). The backend is NCCL
when every rank has a card of its own, else gloo
(``parallel.default_backend``); ``--dist_backend`` names it instead
(``nccl`` with more ranks than cards raises). Rank 0 writes the outputs.
``--ip`` is single-rank only.
"""

from __future__ import annotations

import argparse
import json
import sys
import os
import time
import uuid

import numpy as np
import torch

def build_parser():
    from radegs_torch.train.arguments import add_group
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.utils.device import add_device_arg

    p = argparse.ArgumentParser(description="radegs_torch training")
    add_group(p, ModelConfig, "ModelParams")
    add_group(p, OptimizationConfig, "OptimizationParams")
    add_group(p, PipelineConfig, "PipelineParams")
    p.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--ip", type=str, default=None,
                   help="serve the SIBR network viewer on this host")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--synthetic", action="store_true",
                   help="train on a tiny built-in synthetic scene (no dataset needed)")
    p.add_argument("--multichip", action="store_true",
                   help="train on several ranks (parallel/): a block of the Gaussians and a "
                        "band of every view each")
    p.add_argument("--world_size", type=int, default=0,
                   help="--multichip: ranks to spawn (0: one per card, or 1 with --device "
                        "cpu); ignored under torchrun")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="--multichip: the process group's backend (default nccl when every "
                        "rank has a card of its own, else gloo)")
    add_device_arg(p)
    return p


def synthetic_scene(size=64, n_cams=4, P=80, seed=0, device=None):
    """scripts/train.py:58-83: ``n_cams`` orbit views of ``P`` seeded opaque
    Gaussians as ground truth. Returns (cameras, extent)."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.renderer import render

    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(P, 3)) * 0.5).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, size=(P, 3)).astype(np.float32)
    target = gm.create_from_points(pts, cols, capacity=gm.round_capacity(P, 128), device=device)
    target = target.replace(params=target.params.replace(
        opacity=torch.where(target.active[:, None],
                            gm.inverse_sigmoid(torch.tensor(0.8, device=target.device)),
                            target.params.opacity),
        scaling=target.params.scaling + 0.7))
    cams = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        cam = Camera.look_at([3.5 * np.sin(ang), 0.5, -3.5 * np.cos(ang)], [0, 0, 0], [0, 1, 0],
                             0.9, 0.9, size, size, device=target.device)
        with torch.no_grad():
            gt = render(target, cam, [0.0, 0.0, 0.0], max_per_tile=64, instance_budget=1 << 12,
                        device=target.device)
        cams.append((cam, gt["render"].clamp(0, 1), i))
    return cams, 3.5


def save_snapshot(model_path, state, it):
    from radegs_torch.models import gaussian_model as gm

    d = os.path.join(model_path, "point_cloud", f"iteration_{it}")
    os.makedirs(d, exist_ok=True)
    gm.save_gaussian_ply(os.path.join(d, "point_cloud.ply"), state)


def main(argv=None):
    """Run training. Returns (train_state, history, test_psnr): ``history``
    as written to ``history.json``; ``test_psnr`` {iteration: mean PSNR over
    the test views} for the ``--test_iterations`` that ran (empty without
    test views). With ``--multichip`` spawning its ranks, rank 0's, its
    state moved to the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if not args.multichip:
        return run(args)
    if args.ip:
        raise ValueError("--ip serves the viewer from one rank; train without --multichip")
    import torch.distributed as dist

    from radegs_torch.parallel.launch import default_backend, rank_device, run_ranks
    from radegs_torch.utils.device import resolve_device

    resolve_device(args.device)  # raises for cuda without a card
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        from radegs_torch.parallel.comm import make_mesh_1d

        dev = rank_device(args.device, int(os.environ.get("LOCAL_RANK", 0)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        dist.init_process_group(args.dist_backend or default_backend(local_world, args.device),
                                init_method="env://")
        try:
            return run(args, make_mesh_1d(device=dev))
        finally:
            dist.destroy_process_group()
    world = args.world_size or (torch.cuda.device_count() if args.device == "cuda" else 1)
    return run_ranks(_rank_main, world, args.dist_backend, args.device, timeout_s=None,
                     args=(argv,))[0].result


def _rank_main(mesh, argv):
    ts, history, test_psnr = run(build_parser().parse_args(argv), mesh)
    if mesh.rank:
        return None, history, test_psnr
    return _on_cpu(ts), history, test_psnr


def _on_cpu(ts):
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train.loop import map_app

    g = gm.per_slot(ts.gaussians, lambda x: x.cpu())
    app = {k: None if getattr(ts, k) is None else map_app(lambda x: x.cpu(), getattr(ts, k))
           for k in ("app_params", "app_m", "app_v")}
    return ts.replace(gaussians=g, **app)


def run(args, mesh=None):
    """The training of ``main`` on this process; ``mesh``: this rank's
    ``parallel.Mesh1D`` (multi-rank: only rank 0 writes or prints)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops.ssim import psnr
    from radegs_torch.renderer import render
    from radegs_torch.train.arguments import extract, save_cfg_args
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import SceneLike, init_train_state, train
    from radegs_torch.utils.device import resolve_device

    dev = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    mcfg = extract(ModelConfig, args)
    ocfg = extract(OptimizationConfig, args)
    pcfg = extract(PipelineConfig, args)
    if not mcfg.model_path:
        uid = os.getenv("OAR_JOB_ID", str(uuid.uuid4()))[:10]
        mcfg = ModelConfig(**{**mcfg.__dict__, "model_path": f"./output/{uid}"})
    if lead:
        os.makedirs(mcfg.model_path, exist_ok=True)
        save_cfg_args(mcfg.model_path, mcfg)
        print(f"Output folder: {mcfg.model_path}")

    scene_obj = None
    if args.synthetic:
        cameras, extent = synthetic_scene(seed=args.seed, device=dev)
        test_cams = []
        rng = np.random.default_rng(args.seed + 1)
        gaussians = gm.create_from_points((rng.normal(size=(64, 3)) * 0.5).astype(np.float32),
                                          rng.uniform(size=(64, 3)).astype(np.float32),
                                          sh_degree=mcfg.sh_degree, capacity=128, device=dev)
    else:
        from radegs_torch.data.scene import Scene

        scene_obj = Scene(mcfg.source_path, model_path=mcfg.model_path if lead else None,
                          images=mcfg.images,
                          eval_split=mcfg.eval, white_background=mcfg.white_background,
                          resolution=mcfg.resolution, seed=args.seed, device=dev)
        cameras = scene_obj.getTrainCameras()
        test_cams = scene_obj.getTestCameras()
        extent = scene_obj.cameras_extent
        gaussians = scene_obj.create_gaussians(sh_degree=mcfg.sh_degree)
    scene = SceneLike(cameras=cameras, extent=extent)
    bg = torch.full((3,), 1.0 if mcfg.white_background else 0.0, device=dev)

    # TensorBoard where it imports, as in the reference (train.py:26-30, 238-278)
    tb = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb = SummaryWriter(mcfg.model_path) if lead else None
    except Exception:
        print("Tensorboard not available: not logging progress")

    t_start = time.time()
    last = {"t": t_start, "it": 0}
    test_psnr = {}

    def on_log(it, ts, metrics):
        if metrics is None:
            return
        now = time.time()
        ips = (it - last["it"]) / max(now - last["t"], 1e-9)
        last["t"], last["it"] = now, it
        if tb is not None:
            tb.add_scalar("train_loss_patches/total_loss", metrics["loss"], it)
            tb.add_scalar("train_loss_patches/l1_loss", metrics["l1"], it)
            tb.add_scalar("train_loss_patches/depth_normal_loss", metrics["depth_normal_loss"],
                          it)
            tb.add_scalar("train/psnr", metrics["psnr"], it)
            tb.add_scalar("total_points", metrics["n_active"], it)
            tb.add_scalar("iters_per_s", ips, it)
        if lead and not args.quiet:
            print(f"[{it:6d}] loss {metrics['loss']:.5f}  l1 {metrics['l1']:.5f}  "
                  f"psnr {metrics['psnr']:5.2f}  pts {metrics['n_active']:7d}  {ips:6.2f} it/s",
                  flush=True)

    def on_schedule(it, ts, metrics):
        if mesh is not None and (it in args.save_iterations or it in args.checkpoint_iterations
                                 or (it in args.test_iterations and test_cams)):
            # every rank joins the gather; rank 0 evaluates and writes
            from radegs_torch.parallel import gather_gaussian_state, to_canonical

            ts = ts.replace(gaussians=to_canonical(gather_gaussian_state(ts.gaussians, mesh),
                                                   mesh.world))
        if not lead:
            return
        if it in args.test_iterations and test_cams:
            with torch.no_grad():
                vals = [float(psnr(render(
                    ts.gaussians, cam, bg, kernel_size=mcfg.kernel_size,
                    max_per_tile=pcfg.max_per_tile, tiles_per_block=pcfg.tiles_per_block,
                    device=dev)["render"].clamp(0, 1), gt)) for cam, gt, _ in test_cams]
            test_psnr[it] = float(np.mean(vals))
            print(f"\n[ITER {it}] test PSNR {test_psnr[it]:.3f} over {len(vals)} views\n",
                  flush=True)
            if tb is not None:
                tb.add_scalar("test/psnr", test_psnr[it], it)
        if it in args.save_iterations:
            save_snapshot(mcfg.model_path, ts.gaussians, it)
            print(f"[ITER {it}] saved point cloud", flush=True)
        if it in args.checkpoint_iterations:
            from radegs_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(os.path.join(mcfg.model_path, f"chkpnt{it}"), ts, it)
            print(f"[ITER {it}] saved checkpoint", flush=True)

    resume_state = None
    if args.start_checkpoint:
        from radegs_torch.utils.checkpoint import load_checkpoint

        cam0 = cameras[0][0]
        template = init_train_state(gaussians, mcfg.use_decoupled_appearance, cam0.height,
                                    cam0.width, torch.Generator(device=dev).manual_seed(args.seed))
        resume_state, start_it = load_checkpoint(args.start_checkpoint, template)
        print(f"resumed from {args.start_checkpoint} at iteration {start_it}")

    callbacks = [on_log, on_schedule]
    gui = None
    if args.ip:
        from radegs_torch.viewer.network_gui import NetworkGUI

        gui = NetworkGUI(args.ip, args.port, device=dev)

        def on_gui(it, ts, metrics):
            @torch.no_grad()
            def render_view(cam, scaling_modifier):
                return render(ts.gaussians, cam, bg, kernel_size=mcfg.kernel_size,
                              scaling_modifier=scaling_modifier, max_per_tile=pcfg.max_per_tile,
                              tiles_per_block=pcfg.tiles_per_block, device=dev)["render"]

            gui.poll(render_view, mcfg.source_path or mcfg.model_path, it >= ocfg.iterations)

        callbacks.append(on_gui)

    try:
        ts, history = train(scene, gaussians, mcfg, ocfg, pcfg, seed=args.seed,
                            log_every=args.log_every, callbacks=tuple(callbacks),
                            resume_state=resume_state, mesh=mesh, device=dev)
    finally:
        if gui is not None:
            gui.close()

    it = int(ts.iteration)
    if not lead:
        return ts, history, test_psnr
    save_snapshot(mcfg.model_path, ts.gaussians, it)  # the final snapshot
    with open(os.path.join(mcfg.model_path, "history.json"), "w") as f:
        json.dump(history, f)
    if tb is not None:
        tb.close()
    dt = time.time() - t_start
    final = f", final loss {history[-1]['loss']:.5f}" if history else ""
    ranks = f" on {mesh.world} ranks ({mesh.backend})" if mesh is not None else ""
    print(f"Training complete{ranks}: {it} iters in {dt:.1f}s ({it / max(dt, 1e-9):.2f} it/s)"
          f"{final}")
    return ts, history, test_psnr


if __name__ == "__main__":
    main()
