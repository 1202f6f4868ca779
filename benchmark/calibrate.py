"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size:

    python3 -m benchmark.calibrate --workload <cell> --seeds S1 S2 ... [--control N]

For each seed, the program's compared numbers from a run of the cell
(training needs no window: one step of it; serving a short window of
``--serve-seconds`` at the cell's load, enough for the sampled views).
For the first ``--control`` seeds also the control's numbers: the
reference computed with its blend in bfloat16 (the precision below the
configuration's float32) in the program's place; for training also two
faults planted in that float32 reference in the program's place (the loss
over half the image; the colour gradient altered by x1.5 where the blend
produces it). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from benchmark import check, jobs, run


def serve_control(cfg, mix, seed, device):
    """The reference in bfloat16 against the reference in float32, on the
    views a run samples."""
    from benchmark.reference import fp32
    from benchmark.reference import render as rr

    pts, cols = jobs.scene.points_and_colors(cfg, seed)
    eyes = jobs.orbit_eyes(cfg, mix)
    n = len(eyes)
    rng = jobs.np.random.default_rng([seed, 2])
    start = int(rng.integers(n))
    sample = rng.choice(mix["sample_within"], size=mix["sample_views"], replace=False).tolist()
    cams = jobs.ref_cameras(eyes, cfg, device)
    with fp32():
        params, f3 = jobs.ref_scene(cfg, pts, cols, device)
        pairs = []
        for j in sorted(sample):
            cam = cams[(start + j) % n]
            args = (params, f3, cam, cfg["kernel_size"], cfg["active_sh_degree"])
            pairs.append((check.to_host(rr.render(*args, dtype=torch.bfloat16)),
                          check.to_host(rr.render(*args))))
    return check.serve_numbers(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--serve-seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    _, cfg, mix = run.cell_inputs(bench, args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        train = mix["kind"] == "train"
        res = jobs.KINDS[mix["kind"]](cfg, mix, seed, 0.0 if train else args.serve_seconds,
                                      False, device, time.perf_counter())
        rec = {"seed": seed, "program": res["numbers"], "attempted": res["attempted"],
               "failed": res["failed"]}
        if i < args.control:
            check.free_device()
            if train:
                ref = res["ref"]
                for name, kw in (("control", {"dtype": torch.bfloat16}),
                                 ("half", {"fault": "half"}), ("altered", {"fault": "altered"})):
                    pts, cols, _, gt = jobs.program.inputs(cfg, seed, device)
                    with jobs.fp32():
                        other = jobs.reference_train(cfg, pts, cols, gt, ref["order"], device,
                                                     **kw)
                    rec[name] = check.train_numbers(other, ref)
                    del gt
                    check.free_device()
            else:
                rec["control"] = serve_control(cfg, mix, seed, device)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        check.free_device()


if __name__ == "__main__":
    main()
