"""Training checkpoints (port of ``radegs_tpu/utils/checkpoint.py``; the
reference torch.saves ``(gaussians.capture(), iteration)``, train.py:212-214,
gaussian_model.py:71-109).

A checkpoint is one ``torch.save`` file of host tensors: the Gaussian
parameters, their Adam moments and step, the densification accumulators,
the active mask and the 3D filter, the SH degrees, the appearance parameters
and their moments (when training with decoupled appearance), and the
iteration. The JAX package's orbax checkpoints are not read.

Restore keeps the JAX package's capacity semantics (the reference's
shape-agnostic restore, gaussian_model.py:89-109): the checkpoint's own
capacity is read first, and the result's capacity is max(checkpoint,
template, ``capacity``), grown with empty slots, so a resumed run never
loses headroom it had.
"""

from __future__ import annotations

import os

import torch

from radegs_torch.models import gaussian_model as gm

FORMAT = "radegs_torch-checkpoint-1"
PARAMS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _host(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def save_checkpoint(path: str, train_state, iteration: int):
    g = train_state.gaussians
    gauss = {
        "params": dict(g.params.items()), "adam_m": dict(g.adam_m.items()),
        "adam_v": dict(g.adam_v.items()), "active": g.active, "filter_3d": g.filter_3d,
        **{k: getattr(g, k) for k in gm.TRAINING_FIELDS},
    }
    ckpt = {"format": FORMAT, "iteration": int(iteration), "gaussians": _host(gauss),
            "adam_step": int(g.adam_step), "active_sh_degree": int(g.active_sh_degree),
            "max_sh_degree": int(g.max_sh_degree),
            **{k: _host(getattr(train_state, k)) for k in ("app_params", "app_m", "app_v")}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def _load(path: str, mmap: bool = False):
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)
    if ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not a radegs_torch checkpoint (format "
                         f"{ckpt.get('format')!r}); orbax checkpoints of the JAX package "
                         "are not read")
    return ckpt


def checkpoint_capacity(path: str) -> int:
    """The Gaussian capacity stored in a checkpoint (the file is mapped, not
    read into memory)."""
    return int(_load(path, mmap=True)["gaussians"]["params"]["xyz"].shape[0])


def load_checkpoint(path: str, template_state, capacity: int | None = None):
    """Restore onto the template's device. The template gives the device and
    the capacity floor; whether it trains appearance must match the
    checkpoint. Returns (train_state, iteration) with capacity
    max(checkpoint, template, ``capacity``)."""
    from radegs_torch.train.loop import TrainState

    ckpt = _load(path)
    dev = template_state.gaussians.device
    has_app = ckpt["app_params"] is not None
    if has_app != (template_state.app_params is not None):
        raise ValueError(f"{path}: the checkpoint {'has' if has_app else 'has no'} appearance "
                         "parameters and the template "
                         f"{'has none' if has_app else 'has'}")
    c = _to(ckpt["gaussians"], dev)
    g = gm.GaussianState(
        params=gm.GaussianParams(**{k: c["params"][k] for k in PARAMS}),
        active=c["active"], filter_3d=c["filter_3d"],
        **{k: c[k] for k in gm.TRAINING_FIELDS},
        adam_m=gm.GaussianParams(**{k: c["adam_m"][k] for k in PARAMS}),
        adam_v=gm.GaussianParams(**{k: c["adam_v"][k] for k in PARAMS}),
        adam_step=ckpt["adam_step"], active_sh_degree=ckpt["active_sh_degree"],
        max_sh_degree=ckpt["max_sh_degree"])
    ckpt_cap = g.capacity
    target = max(ckpt_cap, template_state.gaussians.capacity, capacity or 0)
    if target != ckpt_cap:
        g = gm.resize_capacity(g, target)
    it = int(ckpt["iteration"])
    state = TrainState(gaussians=g, iteration=it,
                       **{k: _to(ckpt[k], dev) for k in ("app_params", "app_m", "app_v")})
    return state, it
