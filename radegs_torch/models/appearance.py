"""Decoupled appearance model (port of ``radegs_tpu/models/appearance.py``;
reference GOF scene/appearance_network.py:18-46): a CNN maps the x32
downsampled render, concatenated with a 64-d per-view embedding, to a
full-resolution per-pixel RGB multiplier — 4 pixel-shuffle upsample blocks,
a bilinear x2, two convolutions and a sigmoid. Embedding table 2048 x 64,
std 1e-4 at init (scene/gaussian_model.py:65-69).

Parameters live outside the module, as the JAX package keeps its flax
params: ``app_params = {"net": {name: tensor}, "embeddings": (2048, 64)}``,
applied with ``torch.func.functional_call``, so the training loop's
explicit Adam (and the checkpoint) treat them as plain tensors.

Two details follow the JAX code, not its comments:
- the pixel shuffle splits channels as the JAX NHWC reshape does, channel
  ``(i * r + j) * (C / r^2) + c`` (``F.pixel_shuffle`` reads ``c * r^2 + i *
  r + j``, which would scramble weights carried over from flax);
- the x32 downsample is ``jax.image.resize(..., "linear")``, which
  antialiases when it shrinks: ``F.interpolate(mode="bilinear",
  antialias=True, align_corners=False)``, not the align-corners bilinear its
  docstring names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

NUM_EMBEDDINGS = 2048
EMBED_DIM = 64
# flax's lecun_normal: a normal truncated at 2 sigma, its std corrected by
# the truncation (jax.nn.initializers.variance_scaling)
TRUNC_STD = 0.87962566103423978
# port parameter name -> the flax param tree path of its kernel / bias
FLAX_PATHS = {
    "conv_in": ("Conv_0",),
    "ups.0.conv": ("UpsampleBlock_0", "Conv_0"),
    "ups.1.conv": ("UpsampleBlock_1", "Conv_0"),
    "ups.2.conv": ("UpsampleBlock_2", "Conv_0"),
    "ups.3.conv": ("UpsampleBlock_3", "Conv_0"),
    "conv_mid": ("Conv_1",),
    "conv_out": ("Conv_2",),
}


def pixel_shuffle(x, r: int = 2):
    """(N, C r^2, H, W) -> (N, C, H r, W r) in the JAX package's channel
    order: input channel (i r + j) C + c lands at (h r + i, w r + j, c)."""
    n, ch, h, w = x.shape
    c = ch // (r * r)
    x = x.reshape(n, r, r, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * r, w * r)


class UpsampleBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch // 4, out_ch, 3, padding=1, device=device)

    def forward(self, x):
        return F.relu(self.conv(pixel_shuffle(x, 2)))


class AppearanceNetwork(nn.Module):
    """Input (N, 3 + 64, H/32, W/32) -> multiplier (N, 3, H, W). Built on the
    ``meta`` device by default: the weights come from ``init_appearance`` or
    ``appearance_from_arrays``, passed to ``functional_call``."""

    def __init__(self, out_ch: int = 3, device="meta"):
        super().__init__()
        self.conv_in = nn.Conv2d(3 + EMBED_DIM, 256, 3, padding=1, device=device)
        self.ups = nn.ModuleList([UpsampleBlock(a, b, device=device)
                                  for a, b in ((256, 128), (128, 64), (64, 32), (32, 16))])
        self.conv_mid = nn.Conv2d(16, 16, 3, padding=1, device=device)
        self.conv_out = nn.Conv2d(16, out_ch, 3, padding=1, device=device)

    def forward(self, x):
        x = F.relu(self.conv_in(x))
        for up in self.ups:
            x = up(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = F.relu(self.conv_mid(x))
        return torch.sigmoid(self.conv_out(x))


def init_appearance(generator: torch.Generator, height: int = 0, width: int = 0):
    """(net, app_params) on the generator's device: conv weights from flax's
    lecun_normal distribution (not its values), zero biases, embeddings
    N(0, 1e-4^2). ``height`` / ``width`` are the JAX signature's (flax sizes
    nothing by them)."""
    net = AppearanceNetwork()
    dev = generator.device
    params = {}
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            params[name] = torch.zeros(p.shape, device=dev)
        else:
            std = math.sqrt(1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) / TRUNC_STD
            w = torch.empty(p.shape, device=dev)
            params[name] = nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                                 generator=generator)
    emb = torch.randn((NUM_EMBEDDINGS, EMBED_DIM), generator=generator, device=dev) * 1e-4
    return net, {"net": params, "embeddings": emb}


def appearance_from_arrays(flax_params, embeddings, device=None):
    """The port's app_params from a flax param tree taken as numpy
    (``{"params": {"Conv_0": {"kernel": (3, 3, Cin, Cout), "bias"}, ...}}``,
    with or without the ``params`` root) and the (2048, 64) embedding table:
    kernels become (Cout, Cin, 3, 3). Also carries Adam moments, which have
    the same tree."""
    from radegs_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tree = flax_params.get("params", flax_params)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    net = {}
    for name, path in FLAX_PATHS.items():
        node = tree
        for key in path:
            node = node[key]
        net[f"{name}.weight"] = f32(node["kernel"]).permute(3, 2, 0, 1).contiguous()
        net[f"{name}.bias"] = f32(node["bias"])
    return {"net": net, "embeddings": f32(embeddings)}


def appearance_transform(net, app_params, image, view_idx):
    """The image path of L1_loss_appearance (train.py:37-58): centre-crop to
    a multiple of 32, downsample x32, concatenate the view's embedding, run
    the CNN and multiply the crop. ``image`` (3, H, W). Returns
    (transformed (3, Hc, Wc), (top, left, Hc, Wc))."""
    _, H, W = image.shape
    Hc, Wc = H // 32 * 32, W // 32 * 32
    top, left = H // 2 - Hc // 2, W // 2 - Wc // 2
    crop = image[:, top:top + Hc, left:left + Wc]
    down = F.interpolate(crop[None], size=(Hc // 32, Wc // 32), mode="bilinear",
                         antialias=True, align_corners=False)
    emb = app_params["embeddings"][view_idx]
    emb_map = emb[None, :, None, None].expand(1, emb.shape[0], Hc // 32, Wc // 32)
    mult = functional_call(net, app_params["net"], (torch.cat([down, emb_map], dim=1),))
    return mult[0] * crop, (top, left, Hc, Wc)
