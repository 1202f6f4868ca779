"""Novel-view metrics over dumped renders (port of ``scripts/metrics.py``; the
reference metric.py:36-102): SSIM and PSNR, and LPIPS when a weights file
is given, over ``<model>/test/ours_<iter>/{renders,gt}``, written to
``results.json`` and ``per_view.json`` in the reference's format.

    python -m radegs_torch.scripts.metrics -m <model> [<model> ...] \
        [--lpips_weights lpips_vgg.npz] [--device cpu]

PNGs are read with the port's own decoder (no PIL). SSIM and LPIPS run
their convolutions in float32 on the card (``ops.conv.conv2d_fp32``).
LPIPS is reported only with ``--lpips_weights``; a file that does not load
raises, and no other LPIPS implementation is tried.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def load_dir(d):
    """(names, [(C, H, W) float32 in [0, 1]]) of the PNGs in ``d`` whose
    names hold no "_" (the depth and normal maps beside the renders do)."""
    from radegs_torch.utils.image import read_png

    names = sorted(f for f in os.listdir(d) if f.endswith(".png") and "_" not in f)
    return names, [
        np.asarray(read_png(os.path.join(d, f)), dtype=np.float32).transpose(2, 0, 1) / 255.0
        for f in names
    ]


@torch.no_grad()
def score_method(method_dir, dev, lpips_model=None):
    """Per-view (names, SSIM, PSNR, LPIPS) lists of one ``ours_<iter>``
    directory; LPIPS empty without a model."""
    from radegs_torch.ops.ssim import psnr, ssim

    names, renders = load_dir(os.path.join(method_dir, "renders"))
    _, gts = load_dir(os.path.join(method_dir, "gt"))
    ssims, psnrs, lpipss = [], [], []
    for r, g in zip(renders, gts):
        rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
        ssims.append(float(ssim(rt, gt)))
        psnrs.append(float(psnr(rt, gt)))
        if lpips_model is not None:
            lpipss.append(float(lpips_model(rt, gt)))
    return names, ssims, psnrs, lpipss


def main(argv=None):
    """Score every model; returns {model_path: results.json's dict}."""
    from radegs_torch.utils.device import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="radegs_torch novel-view metrics")
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="LPIPS VGG16 weights (.npz); LPIPS is skipped without it")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    lpips_model = None
    if args.lpips_weights:
        from radegs_torch.eval.lpips import load_weights

        lpips_model = load_weights(args.lpips_weights, device=dev)
    results = {}
    for model_path in args.model_paths:
        print(f"Scene: {model_path}")
        full, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print("  no test renders; run radegs_torch.scripts.render first")
            continue
        for method in sorted(os.listdir(test_dir)):
            t0 = time.perf_counter()
            names, ssims, psnrs, lpipss = score_method(os.path.join(test_dir, method), dev,
                                                       lpips_model)
            dt = time.perf_counter() - t0
            print(f"  {method}: SSIM {np.mean(ssims):.7f}  PSNR {np.mean(psnrs):.7f}"
                  + (f"  LPIPS {np.mean(lpipss):.7f}" if lpipss else "")
                  + f"  ({len(names)} views in {dt:.3f} s)")
            full[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                **({"LPIPS": float(np.mean(lpipss))} if lpipss else {}),
            }
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                **({"LPIPS": dict(zip(names, lpipss))} if lpipss else {}),
            }
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        results[model_path] = full
    return results


if __name__ == "__main__":
    main()
