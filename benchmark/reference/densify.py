"""The reference of training through a densification event of RaDe-GS, in
plain PyTorch, on a state of active rows only (a dict: ``params``, ``m``,
``v`` over ``train.GROUPS``, ``stats`` over ``train.STATS``, ``filter3d``
(n, 1), ``capacity``, ``adam_step``):

- ``densify``: GOF's densify and prune (published
  ``scene/gaussian_model.py:662-741``, ``train.py:178-192``). A row's mean
  screen gradient and mean abs gradient are its sums over its visible
  count; a row is hot when the first reaches the threshold or the second
  reaches Q, the ``1 - ratio`` quantile of the abs gradients (linear
  interpolation, as ``torch.quantile``), ratio the share of rows whose
  first reaches the threshold. Hot rows no larger than ``percent_dense x
  extent`` are cloned at a sampled position, larger ones split into two
  copies of scale / 1.6 at sampled positions and leave. Rows under the
  min opacity, and (after the first opacity reset) rows larger than a
  tenth of the extent, are pruned, the split copies by their own scale.
  The kept rows are laid out [originals | clones | split A | split B];
  rows past the capacity are dropped. The new rows' moments and every
  row's statistics start at zero; the Mip 3D filter is recomputed over the
  training cameras (``scene.filter_3d``); the capacity doubles when the
  count reaches 90% of it (zero padding, which an active-rows state need
  not hold).
- ``step``: the reference training step (``train.Trainer.step``'s render,
  autograd through the blend block by block, statistics) at an iteration
  of its own: the position rate at ``it`` on its schedule, Adam's bias
  corrections at the state's own step count, and the loss without the
  depth-normal term (before ``regularization_from_iter``).

Both run with TF32 off (``fp32``).

The positions a clone or a split copy is sampled at are ``xyz + R (eps
s)`` with eps the row's entry of the draws handed in (three (C, 3)
standard-normal tensors: clone, split A, split B). Faults for the
calibration of the check: ``split_div`` (the published 1.6), ``refresh``
(False leaves each row its source's filter), ``inherit`` (the new rows
carry their source's moments). Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import fp32
from benchmark.reference import render as rr
from benchmark.reference import scene as rs
from benchmark.reference import train as rt

GROUPS, STATS = rt.GROUPS, rt.STATS
HEADROOM = 0.9  # the occupancy at which the capacity doubles


def quantile(values, q):
    """The ``q`` quantile of ``values`` (1-D, float32) by linear
    interpolation between the neighbouring order statistics; ``q`` a
    float32 scalar tensor, the position ``q (n - 1)`` in float32."""
    v = torch.sort(values).values
    n = v.shape[0]
    pos = q * torch.tensor(float(max(n - 1, 0)), dtype=torch.float32, device=v.device)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, max(n - 1, 0))
    hi = torch.clamp(lo + 1, 0, max(n - 1, 0))
    frac = pos - lo.to(torch.float32)
    return v[lo] * (1 - frac) + v[hi] * frac


def _rotate(q, x):
    """R(q / |q|) x, row by row."""
    R = rr._rotmat(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
    return (R * x[:, None, :]).sum(-1)


@fp32()
def densify(state, draws, cams, *, max_grad, min_opacity, extent, percent_dense,
            prune_big_ws, split_div=1.6, refresh=True, inherit=False):
    """(the state after the event, its counts: ``n_clone``, ``n_split``,
    ``n_prune``, ``n_drop``, ``n_active``, ``capacity``)."""
    p, s = state["params"], state["stats"]
    n = p["xyz"].shape[0]
    C = state["capacity"]
    denom = torch.clamp_min(s["denom"], 1.0)
    grads = torch.where(s["denom"] > 0, s["grad_accum"] / denom, 0.0)
    grads_abs = torch.where(s["denom"] > 0, s["grad_abs_accum"] / denom, 0.0)
    passing = grads >= max_grad
    ratio = passing.sum().to(torch.float32) / torch.tensor(float(max(n, 1)),
                                                           dtype=torch.float32,
                                                           device=grads.device)
    hot = passing | (grads_abs >= quantile(grads_abs, 1.0 - ratio))

    scales = torch.exp(p["scaling"])
    big = scales.max(-1).values > percent_dense * extent
    clone, split = hot & ~big, hot & big
    low = torch.sigmoid(p["opacity"][:, 0]) < min_opacity
    wide = (scales.max(-1).values > 0.1 * extent) & bool(prune_big_ws)
    split_scales = scales / split_div
    wide_split = (split_scales.max(-1).values > 0.1 * extent) & bool(prune_big_ws)

    keep = [~split & ~(low | wide), clone & ~(low | wide),
            split & ~(low | wide_split), split & ~(low | wide_split)]
    rows = [torch.arange(n, device=grads.device)[k] for k in keep]

    blocks = []
    for b, (rk, eps) in enumerate(zip(rows, (None,) + tuple(draws))):
        blk = {k: p[k][rk] for k in GROUPS}
        if eps is not None:  # a new row, at a position sampled from its source
            blk["xyz"] = p["xyz"][rk] + _rotate(p["rotation"][rk], eps[rk] * scales[rk])
        if b > 1:
            blk["scaling"] = torch.log(split_scales[rk])
        blocks.append(blk)
    n_new = sum(int(r.shape[0]) for r in rows)
    n_keep = min(n_new, C)

    def cat(parts):
        return torch.cat(parts)[:n_keep]

    params = {k: cat([blk[k] for blk in blocks]) for k in GROUPS}
    moments = {}
    for name in ("m", "v"):
        mom = state[name]
        moments[name] = {k: cat([mom[k][rows[0]]] + [
            mom[k][r] if inherit else torch.zeros_like(mom[k][r]) for r in rows[1:]])
            for k in GROUPS}
    if refresh:
        f3 = rs.filter_3d(params["xyz"], cams)
    else:
        f3 = cat([state["filter3d"][r] for r in rows])
    capacity = 2 * C if n_keep >= HEADROOM * C else C
    zero = torch.zeros((n_keep,), dtype=torch.float32, device=grads.device)
    out = {"params": params, "m": moments["m"], "v": moments["v"],
           "stats": {k: zero.clone() for k in STATS}, "filter3d": f3, "capacity": capacity,
           "adam_step": state["adam_step"]}
    counts = {"n_clone": int(rows[1].shape[0]), "n_split": int(split.sum()),
              "n_prune": int((low | wide).sum()), "n_drop": max(n_new - C, 0),
              "n_active": n_keep, "capacity": capacity}
    return out, counts


def _loss(maps, gt):
    """L1 + D-SSIM (lambda 0.2), without the depth-normal term."""
    img = maps["render"]
    l1 = torch.mean(torch.abs(img - gt))
    return (1.0 - rt.LAMBDA_DSSIM) * l1 + rt.LAMBDA_DSSIM * (1.0 - rt.ssim(img, gt))


@fp32()
def step(state, cam, gt, it: int, kernel_size: float, active_degree: int,
         spatial_lr_scale: float, dtype=torch.float32):
    """One training step of ``state`` at iteration ``it``: (the state after
    it, its loss, its gradients)."""
    W, H = cam.width, cam.height
    f3 = state["filter3d"]
    p = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    off = torch.zeros_like(p["xyz"][:, :2], requires_grad=True)
    # a splat the view culls gets no gradient (as in train.Trainer.step)
    with torch.no_grad():
        seen = rr.preprocess(state["params"], f3, cam, kernel_size, active_degree)["valid"]
    kept = {k: torch.where(seen.reshape((-1,) + (1,) * (v.dim() - 1)), v, v.detach())
            for k, v in p.items()}
    prep = rr.preprocess(kept, f3, cam, kernel_size, active_degree, xy_offset=off)
    raw, lists = rr.raw_maps(prep, W, H, dtype)
    raw = {k: v.requires_grad_(True) for k, v in raw.items()}
    loss = _loss(rr.normalize(raw, cam), gt)
    loss.backward()
    feats = rr.blend_features(prep)
    leaf = {k: v.detach().requires_grad_(True) for k, v in feats.items()}
    abs_grad = rr.backward_blocks(leaf, lists, {k: v.grad for k, v in raw.items()}, W, dtype,
                                  ndc_half=(W * 0.5, H * 0.5))
    g_feat = {k: leaf[k].grad if leaf[k].grad is not None else torch.zeros_like(leaf[k])
              for k in feats}
    torch.autograd.backward([feats[k] for k in feats], [g_feat[k] for k in feats])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in p.items()}
    with torch.no_grad():
        t = state["adam_step"] + 1
        bc1 = float(1.0 - torch.tensor(rt.BETA1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(rt.BETA2, dtype=torch.float32) ** t)
        lrs = dict(rt.LR, xyz=rt.xyz_lr(it, spatial_lr_scale))
        params, m, v = {}, {}, {}
        for k in GROUPS:
            g = grads[k]
            m[k] = rt.BETA1 * state["m"][k] + (1 - rt.BETA1) * g
            v[k] = rt.BETA2 * state["v"][k] + (1 - rt.BETA2) * g * g
            params[k] = state["params"][k] - lrs[k] * (m[k] / bc1) / (
                torch.sqrt(v[k] / bc2) + rt.ADAM_EPS)
        vis = prep["valid"] & (prep["radius"] > 0)
        s = dict(state["stats"])
        gn = torch.linalg.vector_norm(off.grad * torch.tensor([W * 0.5, H * 0.5],
                                                              device=off.device), dim=-1)
        ab = torch.where(vis, abs_grad, 0.0)
        s["grad_accum"] = s["grad_accum"] + torch.where(vis, gn, 0.0)
        s["grad_abs_accum"] = s["grad_abs_accum"] + ab
        s["grad_abs_max"] = torch.maximum(s["grad_abs_max"], ab)
        s["denom"] = s["denom"] + vis.to(torch.float32)
        s["max_radii2d"] = torch.where(vis, torch.maximum(s["max_radii2d"], prep["radius"]),
                                       s["max_radii2d"])
    out = dict(state, params=params, m=m, v=v, stats=s, adam_step=t)
    return out, float(loss.detach()), grads
