"""Adam for the Gaussian parameter groups (port of
``radegs_tpu/train/optim.py``): hand-rolled so densification can carry the
moments through its compaction, with the semantics of
torch.optim.Adam(eps=1e-15) as the reference configures it
(gaussian_model.py:338-353): bias-corrected moments, eps outside the square
root, one step count shared by every group (all groups step together, and
new entries inherit the global bias correction as the reference's cat
surgery gives them).

A train step's Adam and densification statistics go through one entry,
``adam_and_stats``: on a card one launch of ``csrc/adam_stats.cu`` (the
plain chain's bits), on the CPU the plain ``adam_step``,
``add_densification_stats`` and ``update_max_radii`` in that order."""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from radegs_torch.models import gaussian_model as gm
from radegs_torch.models.gaussian_model import GaussianParams, GaussianState
from radegs_torch.native import build
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15

# launches of csrc/adam_stats.cu, counted where the entry launches it (the
# tracer's group "launches.adam")
LAUNCHES = trace.counters("launches.adam", ("adam_stats",))
# the statistics the kernel reads and writes, in the C entry's order
STATS_FIELDS = ("grad_accum", "grad_abs_accum", "grad_abs_max", "denom", "max_radii2d")


@dataclass(frozen=True)
class GroupLRs:
    """Per-group learning rates (OptimizationParams, arguments/__init__.py:79-88)."""

    xyz: float  # scheduled: exp decay x spatial_lr_scale
    f_dc: float = 0.0025
    f_rest: float = 0.0025 / 20.0
    opacity: float = 0.05
    scaling: float = 0.005
    rotation: float = 0.001


def expon_lr(step, lr_init, lr_final, max_steps, lr_delay_steps=0, lr_delay_mult=1.0):
    """Exponential log-lerp schedule (utils/general_utils.py:31-64), computed
    in float32 as the JAX package does; returns a Python float."""
    f32 = torch.float32
    step = torch.tensor(step, dtype=f32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay = 1.0
    if step < 0 or lr_init == 0.0:
        return 0.0
    return float(delay * log_lerp)


def adam_step(state: GaussianState, grads: GaussianParams, lrs: GroupLRs) -> GaussianState:
    """One Adam update, on the active entries only: inactive slots keep their
    parameters, and their gradients enter the moments as zeros."""
    step = state.adam_step + 1
    # bias corrections in float32, as the JAX package computes them
    bc1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** step)
    bc2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** step)
    act = state.active
    new_p, new_m, new_v = {}, {}, {}
    for k, p in state.params.items():
        mask = act.reshape((-1,) + (1,) * (p.dim() - 1))
        g = torch.where(mask, getattr(grads, k), 0.0)
        m = BETA1 * getattr(state.adam_m, k) + (1 - BETA1) * g
        v = BETA2 * getattr(state.adam_v, k) + (1 - BETA2) * g * g
        m_hat = m / bc1
        v_hat = v / bc2
        upd = p - getattr(lrs, k) * m_hat / (torch.sqrt(v_hat) + EPS)
        new_p[k], new_m[k], new_v[k] = torch.where(mask, upd, p), m, v
    return state.replace(params=GaussianParams(**new_p), adam_m=GaussianParams(**new_m),
                         adam_v=GaussianParams(**new_v), adam_step=step)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def adam_and_stats(state: GaussianState, grads: GaussianParams, lrs: GroupLRs, xy_grad,
                   xy_abs_grad, visible, radii, ndc_scale) -> GaussianState:
    """A train step's update of ``state``: one Adam step of the six groups
    from ``grads`` (a tensor that is None counts as zeros), then the
    densification statistics of the step's view.

    ``xy_grad``: (C, 2) the screen-space centre's gradient in pixel units
    (``xy_offset.grad``), scaled here by ``ndc_scale`` = (W / 2, H / 2), two
    floats; ``xy_abs_grad``: (C, 2) the GOF abs-gradient side channel
    (``xy_abs.grad``), of which column 0 is read; either may be None
    (zeros). ``visible``: (C,) bool; ``radii``: (C,) float32.

    On a card one launch of ``csrc/adam_stats.cu`` (``adam_and_stats_kernel``);
    on the CPU ``adam_and_stats_torch``. Both give the same bits."""
    fn = adam_and_stats_kernel if state.device.type == "cuda" else adam_and_stats_torch
    return fn(state, grads, lrs, xy_grad, xy_abs_grad, visible, radii, ndc_scale)


def adam_and_stats_torch(state: GaussianState, grads: GaussianParams, lrs: GroupLRs, xy_grad,
                         xy_abs_grad, visible, radii, ndc_scale) -> GaussianState:
    """``adam_and_stats`` as the plain chain, on any device: ``adam_step``,
    ``add_densification_stats`` with the screen gradient times the NDC
    scale, ``update_max_radii``."""
    C, dev = state.capacity, state.device
    grads = GaussianParams(**{k: torch.zeros_like(p) if getattr(grads, k) is None
                              else getattr(grads, k) for k, p in state.params.items()})
    xy = torch.zeros((C, 2), device=dev) if xy_grad is None else xy_grad
    xy_abs = torch.zeros((C,), device=dev) if xy_abs_grad is None else xy_abs_grad[:, 0]
    scale = torch.tensor([float(s) for s in ndc_scale], dtype=torch.float32, device=dev)
    g = adam_step(state, grads, lrs)
    g = gm.add_densification_stats(g, xy * scale, xy_abs, visible)
    return gm.update_max_radii(g, radii, visible)


def _entry():
    return build.entry("adam_stats", 1, 7, 10)


def adam_and_stats_kernel(state: GaussianState, grads: GaussianParams, lrs: GroupLRs, xy_grad,
                          xy_abs_grad, visible, radii, ndc_scale) -> GaussianState:
    """``adam_and_stats`` as one launch of the kernel over the state's rows
    (CUDA tensors only). Every input must be a contiguous tensor of its
    dtype and shape on the state's device, or it raises; the outputs are new
    tensors from PyTorch's caching allocator."""
    dev, C = state.device, state.capacity
    if dev.type != "cuda":
        raise ValueError(f"the Adam kernel runs on cuda tensors, not {dev}")
    f32 = torch.float32
    step = state.adam_step + 1
    # the bias corrections in float32, as adam_step computes them; PyTorch on
    # a card divides a tensor by a float as a product with its float32
    # reciprocal
    inv = [float(np.float32(1.0) / np.float32(float(1.0 - torch.tensor(b, dtype=f32) ** step)))
           for b in (BETA1, BETA2)]
    groups, widths, out = [], [], {}
    for k, p in state.params.items():
        g, m, v = getattr(grads, k), getattr(state.adam_m, k), getattr(state.adam_v, k)
        for name, x in ((k, p), (f"adam_m.{k}", m), (f"adam_v.{k}", v)) + (
                () if g is None else ((f"grad.{k}", g),)):
            build.check_tensor(name, x, f32, p.shape, dev)
        out[k] = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        groups += [p, g, m, v, *out[k]]
        widths.append(p.numel() // C if C else 0)
    build.check_tensor("active", state.active, torch.bool, (C,), dev)
    build.check_tensor("visible", visible, torch.bool, (C,), dev)
    build.check_tensor("radii", radii, f32, (C,), dev)
    for name, x in (("xy_grad", xy_grad), ("xy_abs_grad", xy_abs_grad)):
        if x is not None:
            build.check_tensor(name, x, f32, (C, 2), dev)
    stats_in = [getattr(state, f) for f in STATS_FIELDS]
    for f, x in zip(STATS_FIELDS, stats_in):
        build.check_tensor(f, x, f32, (C,), dev)
    stats_out = [torch.empty_like(x) for x in stats_in]
    ptrs = [None if x is None else x.data_ptr() for x in (
        *groups, state.active, visible, xy_grad, xy_abs_grad, radii, *stats_in, *stats_out)]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with on_device(dev):
        rc = _entry()(ctypes.addressof(table), C, *widths,
                      *(float(getattr(lrs, k)) for k, _ in state.params.items()), *inv,
                      *(float(s) for s in ndc_scale), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adam_stats kernel launch failed with CUDA error {rc}")
    trace.count("launches.adam", "adam_stats")
    return state.replace(
        params=GaussianParams(**{k: o[0] for k, o in out.items()}),
        adam_m=GaussianParams(**{k: o[1] for k, o in out.items()}),
        adam_v=GaussianParams(**{k: o[2] for k, o in out.items()}), adam_step=step,
        **dict(zip(STATS_FIELDS, stats_out)))


def appearance_adam(app, app_m, app_v, it: int, net_lr: float, emb_lr: float) -> dict:
    """The appearance Adam of loop.py:181-202: dense over every tensor (rows
    of the embedding table that got no gradient still move with their
    moments), bias corrections in float32 from the loop's step ``it``.
    ``app``: the parameters after backward (``.grad`` set or None); returns
    the new ``app_params``, ``app_m`` and ``app_v``."""
    bc1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** it)
    bc2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** it)

    def upd(p, m, v, lr):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        return p.detach() - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS), m, v

    net = {k: upd(app["net"][k], app_m["net"][k], app_v["net"][k], net_lr) for k in app["net"]}
    emb = upd(app["embeddings"], app_m["embeddings"], app_v["embeddings"], emb_lr)
    return {key: {"net": {k: v[i] for k, v in net.items()}, "embeddings": emb[i]}
            for i, key in enumerate(("app_params", "app_m", "app_v"))}
