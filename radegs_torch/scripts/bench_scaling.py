"""Weak-scaling benchmark of the multi-rank train step (port of
``scripts/bench_scaling.py``): for each world size n, n ranks train a cloud
of ``base_gaussians * n`` Gaussians (the capacity scales with the world, so
each rank's share is constant) with ``parallel.make_sharded_train_step``,
and report the ms per iteration of each rank and the communication
accounting: the rows the visibility-compressed gather moved
(``gather_rows``), the visible rows (``n_vis``) and the rows a gather of
every Gaussian would move (``full_gather_rows``).

    python -m radegs_torch.scripts.bench_scaling [--world_sizes 1 2] [--zoom] [--vis_frac 0.5]
    python -m radegs_torch.scripts.bench_scaling --device cpu --world_sizes 1 2 \\
        --base_gaussians 200 --width 64 --height 48

Ranks run NCCL when each has a card of its own, else gloo
(``parallel.default_backend``). Each rank's binning budget and tile cap
are sized from a render of the view (twice its instances, split over the
bands). Ranks that share a card time-share it: their ms is printed as such
and gives no efficiency figure (nor does a CPU run); the weak-scaling
efficiency t(1) / t(n) is printed only for runs with a card per rank that
did all of the view's work, against a world-1 run that did too: a run that
drops rows at the gather cap (``--vis_frac`` below 1) or instances at the
binning caps is marked incomplete and gets none. The GSPMD step of the JAX
script (``--gspmd``) has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from radegs_torch.parallel.step import ROW_WIDTH

ROW_BYTES = 4 * ROW_WIDTH  # a gathered row: float32 columns
# work a step dropped at a cap: a run with any of these above 0 did less than the view
DROPPED = ("n_vis_overflow", "n_overflow", "tile_overflow")


def build(P: int, width: int, height: int, zoom: bool, device):
    """The seeded cloud (the JAX script's draws), its camera and a random
    ground truth: (state, camera, gt)."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.models import gaussian_model as gm

    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(P, 3)) * 1.2).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(P, 3)).astype(np.float32)
    state = gm.create_from_points(pts, cols, capacity=gm.round_capacity(P), device=device)
    state = state.replace(params=state.params.replace(
        scaling=state.params.scaling + float(np.log(0.22))))
    if zoom:  # a close-up that sees a fraction of the cloud: the gather compresses
        cam = Camera.look_at([0.4, 0.5, -1.6], [0.2, 0.1, 0], [0, 1, 0], 0.9, 0.7, width,
                             height, device=device)
    else:
        cam = Camera.look_at([0, 0.8, -5.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, width, height,
                             device=device)
    state = gm.update_3d_filter(state, [cam])
    gt = torch.from_numpy(np.clip(rng.uniform(size=(3, height, width)), 0, 1).astype(
        np.float32)).to(device)
    return state, cam, gt


def rank_bench(mesh, base_gaussians, width, height, iters, warmup, zoom, vis_frac):
    """One rank of a world: ``warmup`` + ``iters`` sharded steps; returns
    (ms per iteration on this rank, the last step's metrics as floats, the
    backend)."""
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.parallel import (band_layout, make_sharded_train_step, pad_gt,
                                       shard_train_state, to_strided)
    from radegs_torch.renderer import render
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import init_train_state

    n = mesh.world
    state, cam, gt = build(base_gaussians * n, width, height, zoom, mesh.device)
    cap = state.capacity
    with torch.no_grad():  # the view's demand (render grows its caps to fit it)
        b = render(state, cam, [0.0, 0.0, 0.0], kernel_size=0.1, device=mesh.device)["binning"]
    pcfg = PipelineConfig(instance_budget=round_budget(2 * int(b.n_instances)),
                          max_per_tile=max(512, 1 << (2 * int(b.max_tile_count) - 1).bit_length()))
    step = make_sharded_train_step(
        ModelConfig(kernel_size=0.1), OptimizationConfig(regularization_from_iter=0),
        pcfg, 5.0, mesh, width, height,
        vis_capacity=max(int(cap // n * vis_frac), 1 << 12))
    gt_p = pad_gt(gt, band_layout(height, n)[2])
    ts = shard_train_state(init_train_state(to_strided(state, n)), mesh)
    bg = torch.zeros(3, device=mesh.device)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        ts, m = step(ts, cam, gt_p, bg)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, m = step(ts, cam, gt_p, bg)
    sync()
    return (1e3 * (time.perf_counter() - t0) / iters, {k: float(v) for k, v in m.items()},
            mesh.backend)


def main(argv=None):
    from radegs_torch.parallel import run_ranks
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base_gaussians", type=int, default=50_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--world_sizes", type=int, nargs="+", default=[1, 2])
    p.add_argument("--zoom", action="store_true",
                   help="a close-up camera that sees a fraction of the cloud")
    p.add_argument("--vis_frac", type=float, default=1.0,
                   help="the per-rank gather cap as a fraction of the per-rank capacity "
                        "(overflow is reported)")
    p.add_argument("--timeout", type=float, default=1200.0, help="seconds per world size")
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    results, t1 = {}, None
    for n in args.world_sizes:
        outs = run_ranks(rank_bench, n, device=args.device, timeout_s=args.timeout,
                         args=(args.base_gaussians, args.width, args.height, args.iters,
                               args.warmup, args.zoom, args.vis_frac))
        ms = [o.result[0] for o in outs]
        m, backend = outs[0].result[1:]
        complete = all(m[k] == 0 for k in DROPPED)
        own_card = backend == "nccl"  # the default backend's rule: a card per rank
        timing = ("card per rank" if own_card else
                  f"{n} ranks time-sharing {max(cards, 1)} card(s)" if cards else "cpu")
        comm = {
            "gather_rows": m["gather_rows"], "n_vis": m["n_vis"],
            "full_gather_rows": m["full_gather_rows"],
            "gather_mb": m["gather_rows"] * ROW_BYTES / 1e6,
            "full_gather_mb": m["full_gather_rows"] * ROW_BYTES / 1e6,
            "compression_vs_full_gather": m["gather_rows"] / max(m["full_gather_rows"], 1.0),
            "ideal_compression": m["n_vis"] / max(m["full_gather_rows"], 1.0),
            "n_vis_overflow": m["n_vis_overflow"],
        }
        row = {"backend": backend, "timing": timing, "complete": complete,
               "ms_per_iter_per_rank": ms,
               "loss": m["loss"], "n_instances": m["n_instances"],
               "n_overflow": m["n_overflow"], "tile_overflow": m["tile_overflow"], "comm": comm}
        line = (f"world={n:2d} ({backend}, {timing})  ms/iter per rank "
                + " ".join(f"{x:.3f}" for x in ms)
                + f"  gaussians={args.base_gaussians * n}  gather {comm['gather_mb']:.3f} MB "
                f"({comm['compression_vs_full_gather']:.3f}x of full, ideal "
                f"{comm['ideal_compression']:.3f}x)")
        if own_card and complete and n == 1:
            t1 = max(ms)
        if own_card and complete and t1 is not None:
            row["weak_scaling_efficiency"] = t1 / max(ms)
            line += f"  efficiency={row['weak_scaling_efficiency']:.3f}"
        line += f"  instances={m['n_instances']:.0f}"
        if not complete:
            line += "  INCOMPLETE (no efficiency): " + ", ".join(
                f"{k} {m[k]:.0f}" for k in DROPPED if m[k] > 0)
        results[n] = row
        print(line, flush=True)
    device = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(json.dumps({"weak_scaling": results, "device": device}))
    return results


if __name__ == "__main__":
    main()
