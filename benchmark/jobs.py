"""The jobs a traffic mix names by its ``kind``, each with its set-up, its
measured window, its traced segment and its check. ``kind(name)`` finds
one: the two of this file (``KINDS``), or a kind file
``benchmark/kinds/<name>.py`` that a later cell brings (its contract is
``kind``'s docstring). The two here start from a scene the benchmark makes
from the seed (the reference's recipe, scales from an exact 3-NN) and hand
the same to the program, as a loaded scene, and to the reference:

- ``train``: the step of ``make_train_step`` over the configuration's
  views, in a seeded stack of permutations as ``train()`` draws them, with
  the loop's one-step-late ``autotune_pipeline`` and no densification.
  Set-up settles the budget on the demand of every view, warms up, and
  takes the first ``check_steps`` steps of the run, which the reference
  follows.
- ``orbit``: a viewer, one client in a closed loop: each request is a
  ``renderer.render`` of the next pose of a seeded orbit, complete when its
  colour image is on the host. Set-up settles
  the buffers on the demand of every pose; every map of a seeded sample of
  the window's views is compared.

A job returns its end-to-end metrics, the counts, the device's peak, the
compared numbers and, traced, the record the per-layer readers read.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import os
import re
import sys
import time
import types

import numpy as np
import torch

from benchmark import check, program, roofline, scene, tracing
from benchmark.reference import fp32
from benchmark.reference import render as rr
from benchmark.reference import scene as rs
from benchmark.reference import train as rt


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev):
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def ref_cameras(eyes, cfg: dict, device):
    o = cfg["orbit"]
    return [rs.look_at(e, [0, 0, 0], [0, 1, 0], o["fovx"], o["fovy"], cfg["width"],
                       cfg["height"], device) for e in eyes]


def scene_params(cfg: dict, pts, cols, device, dist2=None):
    """The scene's arrays made from the point cloud by the reference's
    recipe; ``dist2`` the mean squared 3-NN distances, computed if not given."""
    return rs.initial_params(torch.as_tensor(pts, device=device),
                             torch.as_tensor(cols, device=device), cfg["scale_shrink"],
                             cfg["opacity"], dist2=dist2)


def ref_scene(cfg: dict, pts, cols, device, dist2=None):
    """The reference's parameters and its own 3D filter."""
    params = scene_params(cfg, pts, cols, device, dist2)
    return params, rs.filter_3d(params["xyz"], ref_cameras(scene.view_eyes(cfg), cfg, device))


# ---- train ------------------------------------------------------------------


def reference_train(cfg, pts, cols, gt, order, device, dtype=torch.float32, fault=None,
                    dist2=None):
    """The reference's losses, first gradient, change and statistics norms
    over the views ``order``."""
    params, f3 = ref_scene(cfg, pts, cols, device, dist2)
    cams = ref_cameras(scene.view_eyes(cfg), cfg, device)
    tr = rt.Trainer(params, f3, cfg["kernel_size"], cfg["active_sh_degree"],
                    cfg["spatial_lr_scale"], dtype=dtype, fault=fault)
    p0 = {k: v.clone() for k, v in tr.params.items()}
    losses, grad = [], None
    for i, v in enumerate(order):
        losses.append(tr.step(cams[v], gt[v]))
        if i == 0:
            grad = rt.norms(tr.grads)
    change = rt.norms({k: tr.params[k] - p0[k] for k in rt.GROUPS})
    return {"loss": losses, "grad": grad, "change": change, "stats": rt.norms(tr.stats)}


def run_train(cfg, mix, seed, seconds, trace, device, t_start):
    from radegs_torch.train.loop import autotune_pipeline, init_train_state, make_train_step

    W, H = cfg["width"], cfg["height"]
    pts, cols, eyes, gt = program.inputs(cfg, seed, device)
    cams = program.cameras(eyes, cfg, device)
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=device))
    state = program.load_state(cfg, scene_params(cfg, pts, cols, device, dist2), cams, device)
    mcfg, ocfg, pcfg = program.configs(cfg)
    peak, tile = program.demand(state, cams, mcfg.kernel_size)
    pcfg = program.settle_train(pcfg, state.capacity, peak, tile)
    capacity = state.capacity
    ts = init_train_state(state)
    del state
    bg = torch.zeros(3, device=device)

    def make(p):
        return make_train_step(mcfg, ocfg, p, spatial_lr_scale=cfg["spatial_lr_scale"])

    step_fn = make(pcfg)
    seq = scene.views(cfg["views"], seed)
    for v in scene.first_views(cfg["views"], mix["warmup_steps"], seed):
        _, m = step_fn(ts, cams[v], gt[v], bg, v, W, H)
    float(m["loss"])

    # the loop of train(): autotune against the previous step's counters
    loop = {"pcfg": pcfg, "step": step_fn, "prev": None, "peak": 0.0, "it": 0,
            "drops": [], "losses": []}

    def take(ts, events=None):
        v = next(seq)
        loop["it"] += 1
        ts, m = loop["step"](ts, cams[v], gt[v], bg, v, W, H, events=events)
        prev = loop["prev"]
        if prev is not None:
            n_ovf, t_ovf = float(prev["n_overflow"]), float(prev["tile_overflow"])
            loop["drops"].append(n_ovf + t_ovf)
            loop["peak"] = max(loop["peak"], float(prev["n_instances"]))
            check100 = loop["it"] % 100 == 0
            p2, changed = autotune_pipeline(loop["pcfg"], n_ovf, t_ovf, loop["peak"], capacity,
                                            shrink_check=check100)
            if check100:
                loop["peak"] = 0.0
            if changed:
                loop["pcfg"], loop["step"] = p2, make(p2)
        loop["prev"] = m
        loop["losses"].append(m["loss"])
        return ts, v

    # the checked first steps of the run
    n_check = mix["check_steps"]
    g0 = ts.gaussians
    p0 = {k: v.clone() for k, v in g0.params.items()}
    order, prog = [], {"loss": None}
    for i in range(n_check):
        ts, v = take(ts)
        order.append(v)
        if i == 0:
            prog["grad"] = rt.norms({k: v / (1.0 - rt.BETA1)
                                     for k, v in ts.gaussians.adam_m.items()})
    g = ts.gaussians
    prog["change"] = rt.norms({k: v - p0[k] for k, v in g.params.items()})
    prog["stats"] = rt.norms({"grad_accum": g.grad_accum, "grad_abs_accum": g.grad_abs_accum,
                              "grad_abs_max": g.grad_abs_max, "denom": g.denom,
                              "max_radii2d": g.max_radii2d})
    prog["loss"] = [float(x) for x in loop["losses"][:n_check]]
    del p0, g0, g
    _sync(device)
    setup_s = time.perf_counter() - t_start

    _reset_peak(device)
    gc.collect()
    gc.freeze()
    marks = [] if trace and device.type == "cuda" else None
    first = len(loop["losses"])
    t0 = time.perf_counter()
    while True:
        ev = [] if marks is not None else None
        ts, _ = take(ts, ev)
        if ev is not None:
            marks.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    n = len(loop["losses"]) - first
    last = loop["prev"]
    drops = loop["drops"][first:] + [float(last["n_overflow"]) + float(last["tile_overflow"])]
    losses = torch.stack(loop["losses"][first:]).float().cpu()
    failed = sum(1 for d in drops if d > 0) + int((~torch.isfinite(losses)).sum())
    peak_window = _peak(device)

    out = {
        "metrics": {"train_rays_per_s": (n * W * H / window_s, "rays/s"),
                    "setup_s": (setup_s, "s")},
        "attempted": n, "failed": min(failed, n),
        "memory_peak_bytes": peak_window,
    }
    if trace:
        rcams = ref_cameras(eyes, cfg, device)
        k = mix["trace_steps"]
        counted = []

        def traced():
            nonlocal ts
            for _ in range(k):
                before = ts
                ts, v = take(ts)
                counted.append((before.gaussians, v))
            _sync(device)

        rec = tracing.profile(traced, k, device.type == "cuda")
        rec["stages"] = tracing.stage_medians([tracing.step_stages(ev) for ev in marks or []])
        rec["peak_window_bytes"] = peak_window
        least_f = least_b = 0.0
        for g_before, v in counted:
            c = roofline.count_view(g_before, rcams[v], cfg["kernel_size"])
            least_f += roofline.least_fwd_s(c, W, H)
            least_b += roofline.least_bwd_s(c, W, H)
        rec["least"] = {"blend_fwd": least_f, "blend_bwd": least_b}
        out["record"] = rec
        del counted
    del ts, loop, step_fn, cams
    check.free_device()
    with fp32():
        ref = reference_train(cfg, pts, cols, gt, order, device, dist2=dist2)
    out["numbers"] = check.train_numbers(prog, ref)
    out["ref"] = dict(ref, order=order)
    return out


# ---- orbit ------------------------------------------------------------------


def orbit_eyes(cfg: dict, mix: dict):
    o = cfg["orbit"]
    return scene.orbit_eyes(mix["poses"], o["radius"], o["elev"], o["wave"], mix["phase"])


def run_orbit(cfg, mix, seed, seconds, trace, device, t_start):
    from radegs_torch.renderer import render

    pts, cols = scene.points_and_colors(cfg, seed)
    train_cams = program.cameras(scene.view_eyes(cfg), cfg, device)
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=device))
    state = program.load_state(cfg, scene_params(cfg, pts, cols, device, dist2), train_cams,
                               device)
    mcfg, _, pcfg = program.configs(cfg)
    eyes = orbit_eyes(cfg, mix)
    cams = program.cameras(eyes, cfg, device)
    n_poses = len(cams)
    rng = np.random.default_rng([seed, 2])
    start = int(rng.integers(n_poses))
    sample = set(rng.choice(mix["sample_within"], size=mix["sample_views"],
                            replace=False).tolist())
    peak, tile = program.demand(state, cams, mcfg.kernel_size)
    budget, mpt = program.settle_serve(state.capacity, peak, tile, pcfg.max_per_tile)
    bg = torch.zeros(3, device=device)

    # the frame's host buffer, page-locked once in set-up: a fresh pageable
    # buffer a view costs page faults whose price moves with the host
    host = torch.empty((3, cfg["height"], cfg["width"]), dtype=torch.float32,
                       pin_memory=device.type == "cuda")

    def view(k, events=None):
        out = render(state, cams[(start + k) % n_poses], bg, kernel_size=mcfg.kernel_size,
                     max_per_tile=mpt, instance_budget=budget,
                     tiles_per_block=pcfg.tiles_per_block, device=device, events=events)
        host.copy_(out["render"].detach())
        return out, host

    for k in range(mix["warmup_views"]):
        view(n_poses - 1 - k)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    _reset_peak(device)
    gc.collect()
    gc.freeze()
    marks = [] if trace and device.type == "cuda" else None
    lat, drops, kept = [], [], {}
    k = 0
    t0 = time.perf_counter()
    while True:
        ev = [] if marks is not None else None
        tq = time.perf_counter()
        out, _ = view(k, ev)
        lat.append(time.perf_counter() - tq)
        b = out["binning"]
        drops.append(b.n_overflow + b.tile_overflow)
        if k in sample:
            kept[k] = {m: out[m].detach() for m in check.MAPS}
        if ev is not None:
            marks.append(ev)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak_window = _peak(device)
    failed = int((torch.stack(drops) > 0).sum())
    res = {
        "metrics": {"views_per_s": (k / window_s, "views/s"),
                    "view_ms_p95": (float(np.percentile(np.array(lat) * 1e3, 95)), "ms"),
                    "setup_s": (setup_s, "s")},
        "attempted": k, "failed": failed,
        "memory_peak_bytes": peak_window,
    }
    rcams = ref_cameras(eyes, cfg, device)
    if trace:
        nk = mix["trace_views"]

        def traced():
            for j in range(nk):
                view(k + j)
            _sync(device)

        rec = tracing.profile(traced, nk, device.type == "cuda")
        rec["stages"] = tracing.stage_medians([tracing.step_stages(ev) for ev in marks or []])
        rec["peak_window_bytes"] = peak_window
        least = 0.0
        for j in range(nk):
            c = roofline.count_view(state, rcams[(start + k + j) % n_poses], mcfg.kernel_size)
            least += roofline.least_fwd_s(c, cfg["width"], cfg["height"])
        rec["least"] = {"blend_fwd": least}
        res["record"] = rec
    prog_maps = {j: check.to_host(m) for j, m in kept.items()}
    del state, kept, out
    check.free_device()
    with fp32():
        params, f3 = ref_scene(cfg, pts, cols, device, dist2)
        pairs = []
        for j, pm in sorted(prog_maps.items()):
            rm = rr.render(params, f3, rcams[(start + j) % n_poses], cfg["kernel_size"],
                           cfg["active_sh_degree"])
            pairs.append((pm, check.to_host(rm)))
    res["numbers"] = check.serve_numbers(pairs) if pairs else {"rgb_max_gap": math.inf}
    return res


KINDS = {"train": run_train, "orbit": run_orbit}

KIND_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kinds")
# what a kind file defines (``kind``)
KIND_API = ("run", "controls", "tiny", "CALIBRATE_SECONDS")
_LOADED: dict = {}  # a kind file's path -> its module, loaded once


def kind(name: str):
    """The job of the mix kind ``name``: ``KINDS[name]``, a function, or
    else the module ``KIND_DIR/<name>.py``, loaded by its path once a
    process. A kind file defines:

    - ``run(cfg, mix, seed, seconds, trace, device, t_start)``, which
      returns what ``run_train`` returns: ``metrics``, ``attempted``,
      ``failed``, ``memory_peak_bytes``, ``numbers``, ``record`` when
      traced, and optionally ``ref``; a program mark that
      ``tracing.STAGE_OF`` lacks is declared in the ``stage_of`` it passes
      to ``tracing.step_stages``;
    - ``controls(cfg, mix, seed, device, res)``: ``{name: compared
      numbers}`` of the control (the reference one precision down in the
      program's place) and of any planted faults, for ``calibrate``;
      ``res`` is ``run``'s result for the seed;
    - ``tiny(cfg, mix)``: ``(cfg, mix)`` cut to a size the CPU tests run in
      seconds;
    - ``CALIBRATE_SECONDS``: the window ``calibrate`` runs ``run`` with.

    Configuration keys of its own (a densification schedule, say) a kind
    file reads itself, on top of ``program.configs(cfg)``, and hands the
    same values to its plain reference. A kind file named as one of ``KINDS`` would never be found, so it
    raises."""
    path = os.path.join(KIND_DIR, f"{name}.py")
    if name in KINDS:
        if os.path.isfile(path):
            raise LookupError(f"{path} has the name of the job kind {name!r} of jobs.py")
        return KINDS[name]
    if path in _LOADED:
        return _LOADED[path]
    if not os.path.isfile(path):
        raise LookupError(f"no job kind {name!r}: {path} does not exist")
    mod_name = "benchmark_kind_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered as an import would be: a dataclass in the file looks its
    # module up there
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    missing = [a for a in KIND_API if not hasattr(mod, a)]
    if missing:
        raise LookupError(f"job kind {path} lacks {', '.join(missing)}")
    _LOADED[path] = mod
    return mod


def is_file_kind(job) -> bool:
    """Whether ``kind`` found ``job`` in a kind file (a module), not in ``KINDS``."""
    return isinstance(job, types.ModuleType)
