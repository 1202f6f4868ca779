"""The job of the mix kind ``densify``: training through densification, as
``train()`` runs iterations 500-15,000 of every RaDe-GS run. Each step is
``make_train_step``'s (``train/loop.Autotune``'s), and after it comes
``train/loop.after_step``, what ``train()`` calls there: the event on its
schedule (``densify_event``: densify and prune with compaction, the 3D
filter refresh over every training camera, ``maybe_grow``, the opacity
reset), then the loop's one-step-late autotune on the current capacity.

Set-up, from the seed:

- the target: the configuration's ``target`` point cloud (a generator of
  ``scene.GENERATORS``), its scene made by the reference's recipe and
  loaded into the program; the ground truth is the program's
  ``renderer.render`` of it at every training view (no gradient), data
  the program prepares and hands to both sides;
- the start: the target thinned (``thinned``: every row outside
  ``start.holes`` seeded holes kept, a share ``start.hole_keep`` inside
  them, ``start.n`` rows in all), its scales from the exact 3-NN of the
  kept rows, shaped (``start_params``), loaded at capacity
  ``start.capacity`` with a fresh optimiser at iteration
  ``start.iteration - 1``; the reference builds its own start from the
  same rows (``start_state``: the same parameters, its own 3D filter).

Checked: the run's first steps, from ``start.iteration`` to the first
event (``first_event``, three steps after the start, so the statistics
the event reads come from these steps alone), the event (with normal
draws handed to both sides), and the step after it; the reference
(``reference/densify.py``) runs the same from its own start. The window
then runs whole steps, an event after every
``densification_interval``-th iteration, for ``seconds`` and on to the
first event after them, so that every window ends on an event and holds
the same steps an event; events count in its time and not in its rays.
Traced: the window's steps and events leave their CUDA-event marks and
the tracer's units (``events``: each event's device ms and its least
time, ``densify_bytes``); the three steps after the window, which hold
no event, are profiled for the step's per-layer readings.

The configuration's ``schedule`` (``OptimizationConfig``'s densification
keys, ``min_opacity``) is read here and handed to both sides.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import check, densify_bytes, jobs, program, roofline, scene, tracing
from benchmark.reference import densify as rd
from benchmark.reference import fp32
from benchmark.reference import scene as rs
from benchmark.reference import train as rt

CALIBRATE_SECONDS = 0.0
# the event's marks (train/loop.densify_event) and the stages they end
STAGE_OF = {**tracing.STAGE_OF, "densify.prune": "densify.prune",
            "densify.filter3d": "densify.filter3d", "densify": "densify.grow",
            "reset_opacity": "reset_opacity"}
# devices on which a traced run passes the program its CUDA-event lists
MARK_DEVICES = ("cuda",)
# the schedule's keys that are OptimizationConfig's
OCFG_KEYS = ("densify_from_iter", "densify_until_iter", "densification_interval",
             "densify_grad_threshold", "percent_dense", "opacity_reset_interval",
             "regularization_from_iter")
# the event's counts compared in rows: the reference's names, and the
# program's (``densify_event``'s counts) where they differ
COUNTED = {"n_clone": "cloned", "n_split": "split", "n_prune": "pruned", "n_drop": "dropped",
           "n_active": "active", "capacity": "capacity"}


def optimization(cfg: dict):
    from radegs_torch.train.config import OptimizationConfig

    return OptimizationConfig(**{k: cfg["schedule"][k] for k in OCFG_KEYS})


def first_event(cfg: dict) -> int:
    """The checked event's iteration: the start's third step, which must be
    on the densify schedule, so that the statistics the event reads come
    from the three checked steps alone."""
    s = cfg["schedule"]
    E = cfg["start"]["iteration"] + 2
    if E % s["densification_interval"] or not (
            s["densify_from_iter"] < E < s["densify_until_iter"]):
        raise ValueError(f"start.iteration + 2 = {E} is not on the densify schedule")
    return E


def ground_truth(cfg: dict, pts, cols, cams, device):
    """(views, 3, H, W): the program's render of the target scene at each
    training view."""
    from radegs_torch.renderer import render

    t = cfg["target"]
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=device))
    state = program.load_state(dict(cfg, capacity=t["capacity"]),
                               jobs.scene_params(cfg, pts, cols, device, dist2), cams, device)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        gt = torch.stack([render(state, cam, bg, kernel_size=cfg["kernel_size"],
                                 device=device)["render"] for cam in cams])
    del state
    check.free_device()
    return gt


def thinned(cfg: dict, pts, seed: int, device):
    """The target's rows the start keeps, in the target's order: the rows
    nearest ``start.holes`` centres (target points drawn from the seed) are
    the holes, of which a seeded share ``start.hole_keep`` is kept; every
    other row is kept; ``start.n`` in all."""
    st = cfg["start"]
    n_all, n_keep, share = len(pts), st["n"], st["hole_keep"]
    rng = np.random.default_rng([seed, 3])
    p = torch.as_tensor(pts, device=device)
    centres = p[torch.as_tensor(rng.choice(n_all, size=st["holes"], replace=False),
                                device=device)]
    d2 = torch.empty((n_all,), dtype=torch.float32, device=device)
    for s in range(0, n_all, 1 << 20):
        q = p[s:s + (1 << 20)]
        d2[s:s + q.shape[0]] = sum((q[:, None, i] - centres[None, :, i]) ** 2
                                   for i in range(3)).min(1).values
    n_out = min(max(int(round((n_keep - share * n_all) / (1.0 - share))), 0), n_keep)
    n_hole = n_all - n_out
    order = torch.sort(d2, stable=True).indices.cpu().numpy()
    in_hole = order[:n_hole]
    kept = np.concatenate([order[n_hole:], in_hole[rng.permutation(n_hole)[:n_keep - n_out]]])
    return np.sort(kept)


def start_params(cfg: dict, pts, cols, dist2, seed: int, device) -> dict:
    """The start's parameters by the reference's recipe (``jobs.scene_params``:
    round, unrotated splats of the 3-NN scale), then shaped as training
    leaves them: each log scale moved by a seeded normal of standard
    deviation ``start.anisotropy`` and each rotation a seeded uniform one."""
    params = jobs.scene_params(cfg, pts, cols, device, dist2)
    n = params["xyz"].shape[0]
    rng = np.random.default_rng([seed, 4])
    spread = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(cfg["start"]["anisotropy"])
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params["scaling"] = params["scaling"] + torch.as_tensor(spread, device=device)
    params["rotation"] = torch.as_tensor(q, device=device)
    return params


def start_state(cfg: dict, start, device) -> dict:
    """The reference's start from the start's rows (``start``: their points,
    colours and mean squared 3-NN distances on the host, and the seed): its
    parameters (``start_params``) and its own 3D filter, moments and
    statistics at zero, the start's capacity, Adam's step 0."""
    pts, cols, dist2, seed = start
    params = start_params(cfg, pts, cols, dist2.to(device), seed, device)
    f3 = rs.filter_3d(params["xyz"], jobs.ref_cameras(scene.view_eyes(cfg), cfg, device))
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    n = params["xyz"].shape[0]
    return {"params": params, "m": zero, "v": {k: v.clone() for k, v in zero.items()},
            "stats": {k: torch.zeros((n,), dtype=torch.float32, device=device)
                      for k in rd.STATS},
            "filter3d": f3, "capacity": cfg["start"]["capacity"], "adam_step": 0}


def filter_gap(xyz, f3, rcams) -> float:
    """How far a state's 3D filter lies from the reference's filter of its
    own positions: the norm of the difference over the filter's norm."""
    with fp32():
        want = rs.filter_3d(xyz, rcams)
    return float(torch.linalg.vector_norm((f3 - want).double())
                 / torch.linalg.vector_norm(want.double()))


def event_norms(params, m, v, f3) -> dict:
    return {"params": rt.norms(params), "m": rt.norms(m), "v": rt.norms(v),
            "filter": rt.norms({"filter": f3})}


def event_kwargs(cfg: dict, it: int) -> dict:
    s = cfg["schedule"]
    return {"max_grad": s["densify_grad_threshold"], "min_opacity": s["min_opacity"],
            "extent": cfg["spatial_lr_scale"], "percent_dense": s["percent_dense"],
            "prune_big_ws": it > s["opacity_reset_interval"]}


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers: the train cells' four over the three steps
    before the event; ``count_gap``, the largest difference in rows of the
    event's counts and capacity; ``event_gap``, the worst relative gap of
    the norms of the compacted parameter groups, of each moment's groups
    and of the filter; ``filter_gap``, the side's own filter against the
    reference's filter of its positions; ``after_gap``, the change of the
    step after the event."""
    out = check.train_numbers(prog, ref)
    out["count_gap"] = float(max(abs(prog["counts"][k] - ref["counts"][k]) for k in COUNTED))
    e, r = prog["event"], ref["event"]
    out["event_gap"] = max(check.worst_gap(e[k], r[k], r[k]) for k in ("params", "m", "v",
                                                                          "filter"))
    out["filter_gap"] = prog["filter_gap"]
    g = ref["grad"]
    kept = [k for k in g if g[k] >= 1e-3 * np.median(list(g.values()))]
    out["after_gap"] = check.worst_gap(prog["after"], ref["after"], kept)
    return out


def reference(cfg, start, gt, views, draws, device, dtype=torch.float32, **fault):
    """The reference from its own start (``start_state``): the three steps,
    the event (``fault`` planted in it), the step after it, on the
    ``views`` (their ground truth ``gt``)."""
    rcams = jobs.ref_cameras(scene.view_eyes(cfg), cfg, device)
    args = (cfg["kernel_size"], cfg["active_sh_degree"], cfg["spatial_lr_scale"], dtype)
    E = first_event(cfg)
    state = start_state(cfg, start, device)
    p0 = {k: v.clone() for k, v in state["params"].items()}
    out = {"loss": []}
    for i, it in enumerate(range(E - 2, E + 1)):
        state, loss, grads = rd.step(state, rcams[views[i]], gt[i].to(device), it, *args)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = rt.norms(grads)
        del grads
    out["change"] = rt.norms({k: state["params"][k] - p0[k] for k in rt.GROUPS})
    out["stats"] = rt.norms(state["stats"])
    del p0
    state, out["counts"] = rd.densify(state, [d.to(device) for d in draws], rcams,
                                      **event_kwargs(cfg, E), **fault)
    out["event"] = event_norms(state["params"], state["m"], state["v"], state["filter3d"])
    out["filter_gap"] = filter_gap(state["params"]["xyz"], state["filter3d"], rcams)
    p1 = {k: v.clone() for k, v in state["params"].items()}
    state, loss, _ = rd.step(state, rcams[views[3]], gt[3].to(device), E + 1, *args)
    out["loss"].append(loss)
    out["after"] = rt.norms({k: state["params"][k] - p1[k] for k in rt.GROUPS})
    return out


def event_ms(ev) -> dict:
    """A traced event's device ms from its marks: ``densify_ms`` from the
    step's last mark to ``densify``, ``filter3d_ms`` the refresh's part."""
    names = [n for n, _ in ev]
    i = names.index("densify.prune")
    at = dict(ev)
    out = {"densify_ms": ev[i - 1][1].elapsed_time(at["densify"])}
    if "densify.filter3d" in at:
        out["filter3d_ms"] = at["densify.prune"].elapsed_time(at["densify.filter3d"])
    return out


def run(cfg, mix, seed, seconds, trace, device, t_start):
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train import loop as tl

    W, H = cfg["width"], cfg["height"]
    if cfg["schedule"]["min_opacity"] != tl.MIN_OPACITY:
        raise ValueError(f"train() prunes below opacity {tl.MIN_OPACITY}")
    E = first_event(cfg)
    mcfg, _, pcfg = program.configs(cfg)
    ocfg = optimization(cfg)
    extent = cfg["spatial_lr_scale"]
    eyes = scene.view_eyes(cfg)
    cams = program.cameras(eyes, cfg, device)
    pts, cols = scene.points_and_colors({"points": cfg["target"]}, seed)
    gt = ground_truth(cfg, pts, cols, cams, device)
    kept = thinned(cfg, pts, seed, device)
    pts, cols = pts[kept], cols[kept]
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=device))
    st = cfg["start"]
    state = program.load_state(dict(cfg, capacity=st["capacity"]),
                               start_params(cfg, pts, cols, dist2, seed, device), cams, device)
    start = (pts, cols, dist2.cpu(), seed)
    n = len(kept)
    del dist2
    peak, tile = program.demand(state, cams, mcfg.kernel_size)
    pcfg = program.settle_train(pcfg, state.capacity, peak, tile)
    ts = tl.init_train_state(state).replace(iteration=st["iteration"] - 1)
    del state
    bg = torch.zeros(3, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    tune = tl.Autotune(pcfg, lambda p: tl.make_train_step(mcfg, ocfg, p,
                                                          spatial_lr_scale=extent))
    seq = scene.views(cfg["views"], seed)
    drops, losses = [], []

    def take(ts, events=None, draws=None, peek=None):
        """One iteration of train()'s loop: the step, then ``after_step``
        (the event on its schedule, the autotune)."""
        v = next(seq)
        it = ts.iteration + 1
        ts, m = tune.step(ts, cams[v], gt[v], bg, v, W, H, events=events)
        if peek is not None:
            peek(ts.gaussians)
        ts, counts = tl.after_step(ts, it, m, tune, generator, ocfg, mcfg, extent, cams,
                                   events, draws=draws)
        if tune.read is not None:
            drops.append(tune.read["n_overflow"] + tune.read["tile_overflow"])
        losses.append(m["loss"])
        return ts, v, counts

    # the checked segment: the first three steps, the event, the step after it
    g = ts.gaussians
    p0 = {k: v.clone() for k, v in g.params.items()}
    del g
    draws = gm.normal_draws(generator, ts.gaussians.capacity, device)
    views, prog = [], {}

    def before_event(g):
        # the change and the statistics the event is handed (it zeroes them)
        prog["change"] = rt.norms({k: x[:n] - p0[k][:n] for k, x in g.params.items()})
        prog["stats"] = rt.norms({k: getattr(g, k) for k in rd.STATS})

    for i in range(3):
        last = i == 2
        ts, v, counts = take(ts, draws=draws if last else None,
                             peek=before_event if last else None)
        views.append(v)
        if i == 0:
            prog["grad"] = rt.norms({k: x / (1.0 - rt.BETA1)
                                     for k, x in ts.gaussians.adam_m.items()})
    del p0
    if counts is None:
        raise RuntimeError(f"no densification after iteration {E}")
    g = ts.gaussians
    counts = dict(counts, capacity=g.capacity)
    prog["counts"] = {k: counts[c] for k, c in COUNTED.items()}
    n2 = counts["active"]
    prog["event"] = event_norms({k: x[:n2] for k, x in g.params.items()},
                                {k: x[:n2] for k, x in g.adam_m.items()},
                                {k: x[:n2] for k, x in g.adam_v.items()}, g.filter_3d[:n2])
    prog["filter_gap"] = filter_gap(g.params.xyz[:n2], g.filter_3d[:n2],
                                    jobs.ref_cameras(eyes, cfg, device))
    p1 = {k: x[:n2].clone() for k, x in g.params.items()}
    del g
    ts, v, _ = take(ts)
    views.append(v)
    prog["after"] = rt.norms({k: x[:n2] - p1[k] for k, x in ts.gaussians.params.items()})
    prog["loss"] = [float(x) for x in losses]
    del p1
    jobs._sync(device)
    setup_s = time.perf_counter() - t_start

    jobs._reset_peak(device)
    gc.collect()
    gc.freeze()
    marks = [] if trace and device.type in MARK_DEVICES else None
    first = len(losses)
    events = []
    t0 = time.perf_counter()
    while True:
        ev = [] if marks is not None else None
        ts, _, counts = take(ts, ev)
        if ev is not None:
            marks.append(ev)
        if counts is not None:
            events.append((counts, ev))
            if time.perf_counter() - t0 >= seconds:
                break
    jobs._sync(device)
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    n_steps = len(losses) - first
    # the last step's counters, read as the next step's autotune would
    last = tune.prev
    drops = drops[first:] + [float(last["n_overflow"]) + float(last["tile_overflow"])]
    window_losses = torch.stack(losses[first:]).float().cpu()
    failed = (sum(1 for d in drops if d > 0) + int((~torch.isfinite(window_losses)).sum())
              + sum(1 for c, _ in events if c["dropped"] > 0))
    peak_window = jobs._peak(device)
    out = {
        "metrics": {"train_rays_per_s": (n_steps * W * H / window_s, "rays/s"),
                    "setup_s": (setup_s, "s")},
        "attempted": n_steps, "failed": min(failed, n_steps),
        "memory_peak_bytes": peak_window,
    }
    if trace:
        rcams = jobs.ref_cameras(eyes, cfg, device)
        counted = []

        def traced():
            # the window ended on an event: the next three steps hold none
            nonlocal ts
            for _ in range(3):
                g0 = ts.gaussians
                ts, v, c = take(ts)
                if c is not None:
                    raise RuntimeError("an event inside the profiled steps")
                counted.append((g0.replace(adam_m=None, adam_v=None), v))
            jobs._sync(device)

        rec = tracing.profile(traced, 3, device.type == "cuda")
        rec["stages"] = tracing.stage_medians([tracing.step_stages(ev, STAGE_OF)
                                               for ev in marks or []])
        rec["peak_window_bytes"] = peak_window
        rec["events"] = []
        for c, ev in events:
            if ev is not None:
                e = event_ms(ev)
                e["least_s"] = densify_bytes.least_s(c["active_before"], c["active"],
                                                    cfg["active_sh_degree"])
                rec["events"].append(e)
        least_f = least_b = 0.0
        for g0, v in counted:
            c = roofline.count_view(g0, rcams[v], cfg["kernel_size"])
            least_f += roofline.least_fwd_s(c, W, H)
            least_b += roofline.least_bwd_s(c, W, H)
        rec["least"] = {"blend_fwd": least_f, "blend_bwd": least_b}
        out["record"] = rec
        del counted
    gt4 = gt[torch.as_tensor(views, device=device)].cpu()
    draws = [d[:n].cpu() for d in draws]
    del ts, tune, gt, cams
    check.free_device()
    with fp32():
        ref = reference(cfg, start, gt4, views, draws, device)
    out["numbers"] = numbers(prog, ref)
    out["ref"] = {"nums": ref, "start": start, "gt": gt4, "views": views, "draws": draws}
    return out


# the planted faults of the event: its keyword arguments in the reference
FAULTS = {"split_kept": {"split_div": 1.0}, "unrefreshed": {"refresh": False},
          "inherited": {"inherit": True}}


def controls(cfg, mix, seed, device, res):
    """The control (the reference with its blend in bfloat16) and the three
    planted faults, each in the program's place against the float32
    reference."""
    r = res["ref"]
    out = {}
    for name, kw in (("control", {"dtype": torch.bfloat16}), *FAULTS.items()):
        with fp32():
            other = reference(cfg, r["start"], r["gt"], r["views"], r["draws"], device, **kw)
        out[name] = numbers(other, r["nums"])
        check.free_device()
    return out


def tiny(cfg, mix):
    """A CPU size: a 3,000-point target, the start of 1,700 at capacity
    2,048 from iteration 7,098 on 3 views of 48 x 32, an event every 4
    iterations. A 48 x 32 view's screen gradients run ~25x a full view's
    (the pixel-to-NDC factor over the pixel count), so the threshold is
    2e-3; the extent is 20, so that both clones and splits occur (the
    first event: ~140 clones, ~100 splits, and the capacity doubles)."""
    cfg = dict(cfg, target=dict(cfg["target"], n=3000, capacity=4096),
               start=dict(cfg["start"], n=1700, capacity=2048, iteration=7098, holes=8),
               schedule=dict(cfg["schedule"], densification_interval=4,
                             densify_grad_threshold=0.002),
               spatial_lr_scale=20.0, width=48, height=32, views=3,
               pipeline={"max_per_tile": 64})
    return cfg, mix
