"""The bisect probes (port of ``scripts/_kernel_bisect.py``): the four probe
kernels of ``csrc/bisect_probes.cu`` at the JAX script's shapes (T = 4 grid
steps, feat (25, 1024) float32 from ``numpy.random.default_rng(0)``, start
[0, 100, 300, 700], count [100, 200, 300, 200]). Prints ``name: OK`` when a
probe launches and agrees with its plain version (abs 1e-5 x the sum of
|terms| for the sums and the prefix sum, 1e-5 x max |plain| for the
product), else ``name: FAIL ...``; exits non-zero if any probe failed.

    python -m radegs_torch.scripts.kernel_bisect [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

T, B = 4, 1024
START = [0, 100, 300, 700]
COUNT = [100, 200, 300, 200]
NAMES = {"aligned": "aligned-dma", "window": "window-dma ", "mm_highest": "mm-highest ",
         "tri_mm": "tri-mm     "}


def inputs(device, start=START, count=COUNT, seed=0):
    """The JAX script's operands on ``device``."""
    feat = np.random.default_rng(seed).normal(size=(25, B)).astype(np.float32)
    return (torch.tensor(start, dtype=torch.int32, device=device),
            torch.tensor(count, dtype=torch.int32, device=device),
            torch.from_numpy(feat).to(device))


def seeded_set(seed: int):
    """A seeded (start, count) set of T steps inside B columns: step 0 is
    empty (count 0), step 1 starts unaligned and its last window ends on the
    last column, the rest are random."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, B, T)
    count = rng.integers(0, B - start + 1)
    count[0] = 0
    start[1] = int(rng.integers(1, B // 128)) * 128 + int(rng.integers(1, 128))
    count[1] = B - start[1]
    return start.tolist(), count.tolist()


def tolerance(probe: str, start, count, feat):
    """The allowed max abs difference from the plain version: 1e-5 x the sum
    of |terms| (aligned, window, tri_mm: per step, the largest) or 1e-5 x
    max |plain| (mm_highest)."""
    from radegs_torch.ops import bisect

    a = feat.abs()
    if probe == "mm_highest":
        return 1e-5 * float(bisect.mm_highest_torch(start[:1], count[:1], feat).abs().max())
    if probe == "tri_mm":
        return 1e-5 * float(a[0, :8].sum())
    if probe == "aligned":
        return 1e-5 * float(a[:, :bisect.CH].sum())
    return 1e-5 * float(bisect.window_torch(start, count, a).max()) if start.numel() else 0.0


def check(probe: str, start, count, feat):
    """(max abs error against the plain version, its tolerance, output)."""
    from radegs_torch.ops import bisect

    out = bisect.WRAPPERS[probe](start, count, feat)
    plain = bisect.PLAIN[probe](start, count, feat)
    return float((out - plain).abs().max()), tolerance(probe, start, count, feat), out


def main(argv=None):
    from radegs_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description="radegs_torch bisect probes")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    start, count, feat = inputs(dev)
    failed = 0
    for probe, name in NAMES.items():
        try:
            err, tol, out = check(probe, start, count, feat)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if not (err <= tol and bool(torch.isfinite(out).all())):
                raise AssertionError(f"max abs error {err:.3e} above {tol:.3e}")
            print(f"{name}: OK", flush=True)
        except Exception as e:  # report every probe, as the JAX script does
            failed += 1
            print(f"{name}: FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
