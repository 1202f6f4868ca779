"""DTU chamfer evaluation (port of ``scripts/eval_dtu.py``; the reference's
dtu_eval/eval.py protocol). Needs the official DTU reference data
(``ObsMask/``, ``Points/stl/``) under ``--dataset_dir``; writes
``results.json`` and the coloured error clouds to ``--vis_out_dir``.

    python -m radegs_torch.scripts.eval_dtu --data <mesh .ply> --scan 24 \
        --dataset_dir <DTU reference dir> [--downsample_density 0.2 ...]

Numpy + scipy on the host.
"""

from __future__ import annotations

import argparse


def add_dtu_args(p):
    """The sampling density, patch margin and distance cut-off of the DTU
    protocol, in the scan's units (millimetres for DTU)."""
    p.add_argument("--downsample_density", type=float, default=0.2)
    p.add_argument("--patch_size", type=float, default=60)
    p.add_argument("--max_dist", type=float, default=20)
    p.add_argument("--visualize_threshold", type=float, default=10)


def print_stages(stats):
    print(f"stages: surface sampling {stats['sample_s']:.3f} s ({stats['n_samples']} points), "
          f"radius downsample {stats['downsample_s']:.3f} s ({stats['n_down']} points), "
          f"KD queries {stats['kd_s']:.3f} s")


def main(argv=None):
    """Returns (the result dict of ``evaluate_dtu``, its stage stats)."""
    from radegs_torch.eval.dtu import evaluate_dtu

    p = argparse.ArgumentParser(description="radegs_torch DTU chamfer evaluation")
    p.add_argument("--data", type=str, required=True, help="reconstructed mesh .ply")
    p.add_argument("--scan", type=int, required=True)
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--vis_out_dir", type=str, default=".")
    add_dtu_args(p)
    args = p.parse_args(argv)
    stats = {}
    r = evaluate_dtu(
        args.data, args.scan, args.dataset_dir, out_dir=args.vis_out_dir,
        downsample_density=args.downsample_density, patch_size=args.patch_size,
        max_dist=args.max_dist, visualize_threshold=args.visualize_threshold, stats=stats,
    )
    print(r["mean_d2s"], r["mean_s2d"], r["overall"])
    print_stages(stats)
    return r, stats


if __name__ == "__main__":
    main()
