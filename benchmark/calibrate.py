"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size:

    python3 -m benchmark.calibrate --workload <cell> --seeds S1 S2 ... [--control N]

For each seed, the program's compared numbers from a run of the cell
(training needs no window: one step of it; serving a short window of
``--serve-seconds`` at the cell's load, enough for the sampled views; a
kind file's job the window of its ``CALIBRATE_SECONDS``).
For the first ``--control`` seeds also the control's numbers: the
reference computed with its blend in bfloat16 (the precision below the
configuration's float32) in the program's place; for training also two
faults planted in that float32 reference in the program's place (the loss
over half the image; the colour gradient altered by x1.5 where the blend
produces it); for a kind file's job what its ``controls`` returns. One
JSON line a seed.
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
    readings(cfg, mix, args.seeds, args.control, args.serve_seconds, device)


def readings(cfg, mix, seeds, control, serve_seconds, device):
    """The record of each seed (printed as it comes, and returned): the
    program's numbers, and for the first ``control`` seeds the control's
    and the faults'."""
    job = jobs.kind(mix["kind"])
    file_kind = jobs.is_file_kind(job)
    train = mix["kind"] == "train"
    if file_kind:
        run_job, seconds = job.run, job.CALIBRATE_SECONDS
    else:
        run_job, seconds = job, 0.0 if train else serve_seconds
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = run_job(cfg, mix, seed, seconds, False, device, time.perf_counter())
        rec = {"seed": seed, "program": res["numbers"], "attempted": res["attempted"],
               "failed": res["failed"]}
        if i < control:
            check.free_device()
            if file_kind:
                ctl = job.controls(cfg, mix, seed, device, res)
                clash = sorted(set(ctl) & set(rec))
                if clash:
                    raise ValueError(f"controls name {', '.join(clash)}, keys of the record")
                rec.update(ctl)
            elif train:
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
        out.append(rec)
        check.free_device()
    return out


if __name__ == "__main__":
    main()
