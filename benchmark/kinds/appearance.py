"""The job of the mix kind ``appearance``: the ``train`` mix's steps with
GOF's decoupled appearance on every step, as RaDe-GS's Tanks and Temples
recipe trains (``--use_decoupled_appearance``). Each step is
``make_train_step``'s with ``ModelConfig(use_decoupled_appearance=True)``
on a state from ``init_train_state(..., use_appearance=True)``: the render,
the appearance network on the x32 downsampled centre crop and the view's
embedding row (the view's index), L1 on the transformed crop, D-SSIM and
normal consistency on the raw render, the backward through both, Adam on
the Gaussians and, dense, on the network and the embedding table.

Set-up, from the seed, as ``jobs.run_train``: the scene by the reference's
recipe loaded into the program, the budget settled on every view's
demand, the state from ``init_train_state(..., use_appearance=True)`` with
the starting network and embeddings drawn by the reference
(``reference/appearance.init``, from a generator seeded with the seed +
``appearance.init_seed_offset``) in place of the program's own draw, as
data both sides are fed (``to_port``: the program's channel order), the
warm-up steps, then the run's first ``check_steps`` steps (checked). The
window runs steps over the views in seeded permutations with the loop's
one-step-late autotune (``train/loop.Autotune``), no densification.
Traced: the window's steps leave their CUDA-event marks (the appearance
stages below), and ``trace_steps`` steps after it are profiled; the
profile also sums the device time of the kernels that the network's
convolutions launch (``conv_seconds``), which ``appearance_roofline``
holds against the convolutions' least time.

Checked against ``reference/appearance.py`` (float32, TF32 off), handed the
same scene, views, ground truth and starting network and table: the train
cells' four numbers, ``app_grad_gap`` (the norms of each network tensor's
gradient and of the first view's embedding row's after step 1) and
``app_change_gap`` (their change, and every checked view's row's, after the
checked steps). Controls: the reference with its cuDNN convolutions in TF32
(``tf32``) and its blend in bfloat16 (``control``); planted faults
(``reference/appearance.FAULTS``).

The configuration's ``appearance`` block (the table's size, both learning
rates, the seed offset) is read here and handed to both sides.
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time

import torch

from benchmark import appearance_flops, check, jobs, program, roofline, scene, tracing
from benchmark.reference import appearance as ra
from benchmark.reference import fp32
from benchmark.reference import scene as rs
from benchmark.reference import train as rt

CALIBRATE_SECONDS = 0.0
# the appearance marks (train/loop.compute_loss, make_train_step) and the
# stages they end
STAGE_OF = {**tracing.STAGE_OF, "appearance": "appearance",
            "appearance.bwd_start": "backward", "appearance.bwd": "appearance_bwd",
            "adam.appearance": "appearance_adam"}
# devices on which a traced run passes the program its CUDA-event lists
MARK_DEVICES = ("cuda",)
# the controls (the reference one precision down in the program's place)
CONTROLS = {"tf32": {"tf32": True}, "control": {"dtype": torch.bfloat16}}
# the host ops that run a convolution on the card (the network's through
# cuDNN; the SSIM filter's, depthwise, through them too in the backward)
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def conv_seconds(events) -> float:
    """Device seconds of the kernels that the network's convolutions launch,
    from a Chrome trace's events: each kernel whose launch (its
    ``correlation``) lies inside a ``CONV_OPS`` op on the launching thread,
    less every op that launched a depthwise kernel (the SSIM filter's)."""
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                 and e.get("name") in CONV_OPS)
    op_of = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS or corr is None:
            continue
        inside = [i for i, (a, b, tid) in enumerate(ops) if tid == e["tid"] and a <= e["ts"] <= b]
        if inside:
            op_of[corr] = inside[-1]
    kernels = [(op_of[c], e["name"], e["dur"]) for e in events
               if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS
               and (c := e.get("args", {}).get("correlation")) in op_of]
    ssim = {i for i, name, _ in kernels if "depthwise" in name}
    return sum(d for i, _, d in kernels if i not in ssim) * 1e-6


def profile(fn, n_steps: int, on_card: bool) -> dict:
    """``tracing.profile``'s record, with ``conv_s``: ``conv_seconds`` of
    the same trace (``tracing.profile`` keeps none of its events)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tprofile(activities=acts) as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rec = tracing.reduce_trace(events, n_steps)
    rec["conv_s"] = conv_seconds(events)
    return rec


def configs(cfg: dict):
    """The program's (ModelConfig, OptimizationConfig, PipelineConfig):
    ``program.configs`` with decoupled appearance and its learning rates."""
    from radegs_torch.train.config import replace

    mcfg, ocfg, pcfg = program.configs(cfg)
    a = cfg["appearance"]
    return (replace(mcfg, use_decoupled_appearance=True),
            replace(ocfg, appearance_network_lr=a["network_lr"],
                    appearance_embeddings_lr=a["embeddings_lr"]), pcfg)


def crop(cfg: dict):
    """(Hc, Wc): the centre crop the network runs on."""
    return ra.crop_box(cfg["height"], cfg["width"])[2:]


def app_gap(prog: dict, ref: dict) -> float:
    """The worst gap of the network tensors' norms and of the embedding
    rows' norms, each family over its own median."""
    return max(check.worst_gap(prog, ref, [k for k in ref if k.startswith(pre)])
               for pre in ("net.", "emb."))


def numbers(prog: dict, ref: dict) -> dict:
    """The train cells' four, ``app_grad_gap`` and ``app_change_gap``."""
    out = check.train_numbers(prog, ref)
    out["app_grad_gap"] = app_gap(prog["app_grad"], ref["app_grad"])
    out["app_change_gap"] = app_gap(prog["app_change"], ref["app_change"])
    return out


def reference(cfg, pts, cols, gt, order, app0, device, dist2=None, dtype=torch.float32,
              tf32=False, fault=None):
    """The reference's numbers over the views ``order`` (their ground truth
    ``gt``, in that order) from the starting appearance tree ``app0``
    (``reference/appearance.init``'s)."""
    params, f3 = jobs.ref_scene(cfg, pts, cols, device, dist2)
    cams = jobs.ref_cameras(scene.view_eyes(cfg), cfg, device)
    a = cfg["appearance"]
    app = ra.map_tree(lambda x: x.to(device), app0)
    tr = ra.Trainer(params, f3, cfg["kernel_size"], cfg["active_sh_degree"],
                    cfg["spatial_lr_scale"], app, (a["network_lr"], a["embeddings_lr"]),
                    dtype=dtype, tf32=tf32, fault=fault)
    del params
    p0 = {k: v.clone() for k, v in tr.params.items()}
    out = {"loss": []}
    for i, v in enumerate(order):
        out["loss"].append(tr.step(cams[v], gt[i].to(device), v))
        if i == 0:
            out["grad"] = rt.norms(tr.grads)
            out["app_grad"] = ra.norms(tr.app_grads, order[:1])
    out["change"] = rt.norms({k: tr.params[k] - p0[k] for k in rt.GROUPS})
    out["app_change"] = ra.norms(ra.map_tree(lambda x, y: x - y, tr.app, app), order)
    out["stats"] = rt.norms(tr.stats)
    return out


def run(cfg, mix, seed, seconds, trace, device, t_start):
    from radegs_torch.models import appearance as pa
    from radegs_torch.train import loop as tl

    W, H = cfg["width"], cfg["height"]
    a = cfg["appearance"]
    if (a["num_embeddings"], a["embedding_dim"]) != (pa.NUM_EMBEDDINGS, pa.EMBED_DIM):
        raise ValueError(f"the program's table is {pa.NUM_EMBEDDINGS} x {pa.EMBED_DIM}")
    if cfg["views"] > a["num_embeddings"]:
        raise ValueError(f"{cfg['views']} views past {a['num_embeddings']} embeddings")
    mcfg, ocfg, pcfg = configs(cfg)
    pts, cols, eyes, gt = program.inputs(cfg, seed, device)
    cams = program.cameras(eyes, cfg, device)
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=device))
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, device, dist2), cams,
                               device)
    peak, tile = program.demand(state, cams, mcfg.kernel_size)
    pcfg = program.settle_train(pcfg, state.capacity, peak, tile)
    capacity = state.capacity
    init_seed = seed + a["init_seed_offset"]
    ts = tl.init_train_state(state, True, H, W,
                             generator=torch.Generator(device=device).manual_seed(init_seed))
    del state
    app0 = ra.init(torch.Generator().manual_seed(init_seed))
    ts = ts.replace(app_params=ra.map_tree(lambda x: x.to(device), ra.to_port(app0)))
    bg = torch.zeros(3, device=device)
    tune = tl.Autotune(pcfg, lambda p: tl.make_train_step(
        mcfg, ocfg, p, spatial_lr_scale=cfg["spatial_lr_scale"]))
    seq = scene.views(cfg["views"], seed)
    for v in scene.first_views(cfg["views"], mix["warmup_steps"], seed):
        _, m = tune.step(ts, cams[v], gt[v], bg, v, W, H)
    float(m["loss"])
    drops, losses = [], []

    def take(ts, events=None):
        """One step of the loop: the step, then the autotune on the
        previous step's counters."""
        v = next(seq)
        ts, m = tune.step(ts, cams[v], gt[v], bg, v, W, H, events=events)
        tune.after(ts.iteration, m, capacity)
        if tune.read is not None:
            drops.append(tune.read["n_overflow"] + tune.read["tile_overflow"])
        losses.append(m["loss"])
        return ts, v

    # the checked first steps of the run
    n_check = mix["check_steps"]
    p0 = {k: v.clone() for k, v in ts.gaussians.params.items()}
    a0 = tl.map_app(torch.clone, ts.app_params)
    order, prog = [], {}
    for i in range(n_check):
        ts, v = take(ts)
        order.append(v)
        if i == 0:
            prog["grad"] = rt.norms({k: x / (1.0 - rt.BETA1)
                                     for k, x in ts.gaussians.adam_m.items()})
            prog["app_grad"] = ra.norms(ra.from_port(tl.map_app(
                lambda x: x / (1.0 - rt.BETA1), ts.app_m)), [v])
    g = ts.gaussians
    prog["change"] = rt.norms({k: x - p0[k] for k, x in g.params.items()})
    prog["app_change"] = ra.norms(ra.from_port(tl.map_app(lambda x, y: x - y, ts.app_params,
                                                          a0)), order)
    prog["stats"] = rt.norms({k: getattr(g, k) for k in rt.STATS})
    prog["loss"] = [float(x) for x in losses[:n_check]]
    del p0, a0, g
    jobs._sync(device)
    setup_s = time.perf_counter() - t_start

    jobs._reset_peak(device)
    gc.collect()
    gc.freeze()
    marks = [] if trace and device.type in MARK_DEVICES else None
    first = len(losses)
    t0 = time.perf_counter()
    while True:
        ev = [] if marks is not None else None
        ts, _ = take(ts, ev)
        if ev is not None:
            marks.append(ev)
        if time.perf_counter() - t0 >= seconds:
            break
    jobs._sync(device)
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    n = len(losses) - first
    last = tune.prev
    drops = drops[first:] + [float(last["n_overflow"]) + float(last["tile_overflow"])]
    window_losses = torch.stack(losses[first:]).float().cpu()
    failed = sum(1 for d in drops if d > 0) + int((~torch.isfinite(window_losses)).sum())
    peak_window = jobs._peak(device)
    out = {
        "metrics": {"train_rays_per_s": (n * W * H / window_s, "rays/s"),
                    "setup_s": (setup_s, "s")},
        "attempted": n, "failed": min(failed, n),
        "memory_peak_bytes": peak_window,
    }
    if trace:
        rcams = jobs.ref_cameras(eyes, cfg, device)
        k = mix["trace_steps"]
        counted = []

        def traced():
            nonlocal ts
            for _ in range(k):
                g0 = ts.gaussians
                ts, v = take(ts)
                counted.append((g0.replace(adam_m=None, adam_v=None), v))
            jobs._sync(device)

        rec = profile(traced, k, device.type == "cuda")
        rec["stages"] = tracing.stage_medians([tracing.step_stages(ev, STAGE_OF)
                                               for ev in marks or []])
        rec["peak_window_bytes"] = peak_window
        least_f = least_b = 0.0
        for g0, v in counted:
            c = roofline.count_view(g0, rcams[v], cfg["kernel_size"])
            least_f += roofline.least_fwd_s(c, W, H)
            least_b += roofline.least_bwd_s(c, W, H)
        rec["least"] = {"blend_fwd": least_f, "blend_bwd": least_b,
                        "appearance": k * appearance_flops.least_s(*crop(cfg))}
        out["record"] = rec
        del counted
    gt3 = gt[torch.as_tensor(order, device=device)].cpu()
    del ts, tune, gt, cams
    check.free_device()
    with fp32():
        ref = reference(cfg, pts, cols, gt3, order, app0, device, dist2=dist2)
    out["numbers"] = numbers(prog, ref)
    out["ref"] = {"nums": ref, "pts": pts, "cols": cols, "gt": gt3, "order": order,
                  "app0": app0, "dist2": dist2.cpu()}
    return out


def controls(cfg, mix, seed, device, res):
    """The two controls and the three planted faults, each the reference
    in the program's place against the float32 reference."""
    r = res["ref"]
    out = {}
    for name, kw in (*CONTROLS.items(), *((f, {"fault": f}) for f in ra.FAULTS)):
        with fp32():
            other = reference(cfg, r["pts"], r["cols"], r["gt"], r["order"], r["app0"], device,
                              dist2=r["dist2"].to(device), **kw)
        out[name] = numbers(other, r["nums"])
        check.free_device()
    return out


def tiny(cfg, mix):
    """A CPU size: 4,000 points at capacity 4,096 on 3 views of 64 x 48
    (the crop 64 x 32, the network from 2 x 1 pixels)."""
    cfg = dict(cfg, points=dict(cfg["points"], n=4000), capacity=4096, width=64, height=48,
               views=3, pipeline={"max_per_tile": 64})
    return cfg, mix
