"""The comparison that decides ``correct``: the numbers a run compares with
the plain reference, and their limits (``limits/<cell>.json``, each set
from the readings of sound runs and of the control, which ``PERF.md``
lists).

Training: the loss of each checked step, each parameter group's gradient
norm after the first step (the program's, from its Adam state), each
group's change over the checked steps, and each densification statistic's
norm after them. A norm is compared by its gap from the reference's,
over the larger of that group's reference norm and the median group's;
the worst group is the number. Groups whose reference gradient is under a
thousandth of the median group's (the SH rest at degree 0) are left out of
the gradient and the change.

Serving: every map ``render`` returns, of the sampled views, against the
reference's render of the same poses: the colour's largest and mean
absolute gaps, and the mean absolute gap of each other map (the mask, the
expected and median depths, the expected and median coordinates, the
normal). A median is a mean gap: where the transmittance crosses one half
within rounding of a splat's edge, the two sides may name neighbouring
splats at a few pixels.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the maps of ``render`` and the name of each one's mean gap
MAPS = ("render", "mask", "expected_depth", "median_depth", "expected_coord",
        "median_coord", "normal")
MEAN_GAPS = {"render": "rgb_mean_gap", "mask": "mask_mean_gap",
             "expected_depth": "depth_mean_gap", "median_depth": "median_depth_mean_gap",
             "expected_coord": "coord_mean_gap", "median_coord": "median_coord_mean_gap",
             "normal": "normal_mean_gap"}


def worst_gap(prog: dict, ref: dict, keys) -> float:
    """The largest gap of the ``keys``' norms; a norm that is not finite on
    either side reads inf."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``loss`` (a list), ``grad``, ``change`` and
    ``stats`` (dicts of norms)."""
    g = ref["grad"]
    med = statistics.median(g.values())
    kept = [k for k in g if g[k] >= 1e-3 * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    loss_gap = max(x if math.isfinite(x) else math.inf for x in losses)
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_gap(prog["grad"], g, kept),
        "change_gap": worst_gap(prog["change"], ref["change"], kept),
        "stats_gap": worst_gap(prog["stats"], ref["stats"], ref["stats"]),
    }


def serve_numbers(pairs) -> dict:
    """``pairs``: (program maps, reference maps) of each sampled view; the
    worst view's gaps."""
    out = dict.fromkeys(["rgb_max_gap", *MEAN_GAPS.values()], 0.0)
    for p, r in pairs:
        vals = {"rgb_max_gap": float((p["render"] - r["render"]).abs().max())}
        for m, name in MEAN_GAPS.items():
            vals[name] = float((p[m] - r[m]).abs().double().mean())
        for k, v in vals.items():
            out[k] = max(out[k], v) if math.isfinite(v) else math.inf
    return out


def load_limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f)["limits"].items()}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and a number with no limit is a failure."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def to_host(maps: dict, keys=MAPS) -> dict:
    return {k: maps[k].detach().float().cpu() for k in keys}


def free_device():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
