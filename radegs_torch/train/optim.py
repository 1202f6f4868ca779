"""Adam for the Gaussian parameter groups (port of
``radegs_tpu/train/optim.py``): hand-rolled so densification can carry the
moments through its compaction, with the semantics of
torch.optim.Adam(eps=1e-15) as the reference configures it
(gaussian_model.py:338-353): bias-corrected moments, eps outside the square
root, one step count shared by every group (all groups step together, and
new entries inherit the global bias correction as the reference's cat
surgery gives them)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from radegs_torch.models.gaussian_model import GaussianParams, GaussianState

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


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
