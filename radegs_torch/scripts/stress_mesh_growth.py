"""Growth stress of multi-rank training (port of
``scripts/stress_mesh_growth.py``): the multi-rank training loop runs
repeated densify -> capacity growth -> strided rebalance cycles up to
``--target`` active Gaussians, and is held to the single-rank loop on the
same scene.

The scene puts the particle-axis machinery (densify compaction,
``maybe_grow``'s capacity doubling, the strided rebalance, the budget and
gather-cap autotune) at million-Gaussian scale while the blend stays small:
a 128x128 view of a dense surface cloud of tiny splats (3-NN scales), with
a near-zero ``densify_grad_threshold``, so clone and split fire on every
visible splat at each densification (every 3 iterations).

Parity (the JAX script's criteria): the active counts within 0.6% (at
least 5), the last loss within 2e-3 relative, and the geometry: the same
count gives max |xyz| difference < 2e-3, otherwise the clouds' chamfer
distance below twice the reference cloud's own mean neighbour spacing.
Borderline clone / prune decisions may flip between the two loops, since
their losses are summed in another order. The JAX script also counts XLA
recompiles; eager PyTorch compiles nothing, so that count has no
counterpart here.

    python -m radegs_torch.scripts.stress_mesh_growth [--target 1000000] [--world_size 2] \\
        [--report PATH]

The ranks' backend is ``parallel.default_backend``'s: NCCL when each rank
has a card of its own, else gloo.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def cloud_chamfer(a: np.ndarray, b: np.ndarray, n_sample: int = 200_000):
    """Symmetric mean nearest-neighbour distance of two point clouds."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    sa = a[rng.choice(len(a), min(n_sample, len(a)), replace=False)]
    sb = b[rng.choice(len(b), min(n_sample, len(b)), replace=False)]
    d_ab, _ = cKDTree(b).query(sa, workers=-1)
    d_ba, _ = cKDTree(a).query(sb, workers=-1)
    return float(d_ab.mean() + d_ba.mean()) / 2


def mean_spacing(xyz: np.ndarray, n_sample: int = 200_000):
    """The cloud's mean distance to its nearest other point."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(1)
    s = xyz[rng.choice(len(xyz), min(n_sample, len(xyz)), replace=False)]
    d2, _ = cKDTree(xyz).query(s, k=2, workers=-1)
    return float(d2[:, 1].mean())


def build_scene(n0: int, width: int, height: int, device, seed: int = 0):
    """The JAX script's scene (its draws in its order): a noisy sphere of
    ``n0`` points, one camera, a random ground truth."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.models import gaussian_model as gm

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n0, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * (1.3 + 0.03 * rng.normal(size=(n0, 1)))).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n0, 3)).astype(np.float32)
    cam = Camera.look_at([0, 0.6, -4.2], [0, 0, 0], [0, 1, 0], 0.8, 0.8, width, height,
                         device=device)
    state = gm.update_3d_filter(gm.create_from_points(pts, cols, sh_degree=0, device=device),
                                [cam])
    gt = torch.from_numpy(np.clip(rng.uniform(size=(3, height, width)), 0, 1).astype(
        np.float32)).to(device)
    return state, cam, gt


def run_loop(state, cam, gt, iters: int, max_per_tile: int, mesh=None, device=None):
    """Train with densification every 3 iterations (clone / split of every
    visible splat, no opacity reset). Returns (canonical state, history)."""
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import SceneLike, train

    ocfg = OptimizationConfig(
        iterations=iters, regularization_from_iter=0, densify_from_iter=1,
        densification_interval=3, densify_until_iter=10_000, densify_grad_threshold=1e-9,
        opacity_reset_interval=1_000_000, percent_dense=0.01)
    return train(SceneLike(cameras=[(cam, gt, 0)], extent=3.5), state,
                 ModelConfig(kernel_size=0.1),
                 ocfg, PipelineConfig(max_per_tile=max_per_tile, instance_budget=1 << 18),
                 log_every=3, mesh=mesh, device=device)


def active_xyz(ts):
    g = ts.gaussians
    return g.params.xyz[g.active].cpu().numpy()


def rank_loop(mesh, n0, width, iters, mpt):
    """One rank of the multi-rank loop; rank 0 returns (history, capacity,
    active xyz, backend), the others (history, capacity, None, backend)."""
    state, cam, gt = build_scene(n0, width, width, mesh.device)
    ts, hist = run_loop(state, cam, gt, iters, mpt, mesh=mesh, device=mesh.device)
    return (hist, ts.gaussians.capacity, active_xyz(ts) if mesh.rank == 0 else None,
            mesh.backend)


def main(argv=None):
    from radegs_torch.parallel import run_ranks
    from radegs_torch.utils.device import add_device_arg, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", type=int, default=1_000_000)
    ap.add_argument("--n0", type=int, default=150_000)
    ap.add_argument("--iters", type=int, default=21)
    ap.add_argument("--width", type=int, default=128, help="square image side")
    ap.add_argument("--mpt", type=int, default=2048, help="max_per_tile")
    ap.add_argument("--world_size", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--report", type=str, default=None, help="write the report here (JSON)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    state, cam, gt = build_scene(args.n0, args.width, args.width, dev)
    print(f"[stress] start: n0={args.n0} capacity={state.capacity} target={args.target} "
          f"world={args.world_size}", flush=True)
    t0 = time.time()
    ts_ref, hist_ref = run_loop(state, cam, gt, args.iters, args.mpt, device=dev)
    ref_s = time.time() - t0
    n_ref, cap_ref = int(ts_ref.gaussians.n_active()), ts_ref.gaussians.capacity
    xyz_ref = active_xyz(ts_ref)
    del ts_ref, state
    print(f"[stress] single rank: n_active={n_ref} capacity={cap_ref} ({ref_s:.1f} s)",
          flush=True)

    t0 = time.time()
    outs = run_ranks(rank_loop, args.world_size, device=args.device, timeout_s=args.timeout,
                     args=(args.n0, args.width, args.iters, args.mpt))
    sh_s = time.time() - t0
    hist_sh, cap_sh, xyz_sh, backend = outs[0].result
    n_sh = len(xyz_sh)
    print(f"[stress] {args.world_size} ranks ({backend}): n_active={n_sh} capacity={cap_sh} "
          f"({sh_s:.1f} s, rank start-up included)", flush=True)
    for i, (a, b) in enumerate(zip(hist_ref, hist_sh)):
        print(f"[stress] log {i}: loss single {a['loss']:.5f} ranks {b['loss']:.5f} "
              f"(d {abs(a['loss'] - b['loss']):.2e}), n_active {a['n_active']} / "
              f"{b['n_active']}", flush=True)

    dn = abs(n_sh - n_ref)
    if n_sh == n_ref:
        max_dxyz, chamfer, nn_ref = float(np.abs(xyz_sh - xyz_ref).max()), 0.0, 0.0
    else:
        max_dxyz, chamfer, nn_ref = None, cloud_chamfer(xyz_ref, xyz_sh), mean_spacing(xyz_ref)
    loss_ref, loss_sh = hist_ref[-1]["loss"], hist_sh[-1]["loss"]
    print(f"[stress] parity: dn={dn} ({dn / max(n_ref, 1):.2%}) chamfer={chamfer:.2e} "
          f"nn_ref={nn_ref:.2e} max_dxyz={max_dxyz} loss d={abs(loss_sh - loss_ref):.2e}",
          flush=True)
    failed = []
    if n_sh == n_ref and not max_dxyz < 2e-3:
        failed.append(f"max |dxyz| {max_dxyz} >= 2e-3")
    if n_sh != n_ref and not chamfer < 2.0 * nn_ref:
        failed.append(f"chamfer {chamfer} >= 2 x spacing {nn_ref}")
    if dn > max(5, int(6e-3 * n_ref)):
        failed.append(f"active counts {n_sh} vs {n_ref}")
    if not abs(loss_sh - loss_ref) <= 2e-3 * max(abs(loss_ref), 1e-3):
        failed.append(f"loss {loss_sh} vs {loss_ref}")
    if n_sh < 0.99 * args.target:
        failed.append(f"growth never reached {args.target}: {n_sh}")
    report = {
        "n0": args.n0, "target": args.target, "iters": args.iters, "resolution": args.width,
        "max_per_tile": args.mpt, "world_size": args.world_size, "backend": backend,
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "n_active_ref": n_ref, "n_active_sharded": n_sh, "capacity_final": cap_sh,
        "parity_count_delta": dn, "parity_max_dxyz": max_dxyz, "parity_cloud_chamfer": chamfer,
        "loss_ref": loss_ref, "loss_sharded": loss_sh, "ref_wall_s": ref_s,
        "sharded_wall_s": sh_s, "history_ref": hist_ref, "history_sharded": hist_sh,
        "failed": failed,
    }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if failed:
        raise SystemExit("[stress] FAILED: " + "; ".join(failed))
    print("[stress] OK", flush=True)
    return report


if __name__ == "__main__":
    main()
