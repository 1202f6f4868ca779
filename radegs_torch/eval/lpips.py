"""LPIPS v0.1 (VGG16 backbone) as a torch module (port of
``radegs_tpu/eval/lpips.py``).

The reference's bundled lpipsPyTorch (`lpipsPyTorch/modules/lpips.py:17-36`,
`modules/networks.py:86-96`, `modules/utils.py:6-8`): z-score the inputs
with the official shift / scale, run the VGG16 features, tap the five ReLU
outputs (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), unit-normalise each
over its channels, square the difference, apply the learned non-negative
1x1 heads, average over the pixels and sum the five layer scores.

Inputs are [0, 1] images fed straight into the z-score, with no rescale to
[-1, 1], as the reference's `metric.py:74` feeds them.

Weights come from a local ``.npz`` (the JAX package's
``scripts/convert_lpips_weights.py`` writes one from torchvision's VGG16 and
the official linear heads; it needs a download). The path is an argument:
nothing is fetched and no environment variable chooses it. Every
convolution goes through ``ops.conv.conv2d_fp32``, so the card computes the
JAX package's float32 LPIPS whatever ``torch.backends.cudnn.allow_tf32``
says.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radegs_torch.ops.conv import conv2d_fp32
from radegs_torch.utils.device import resolve_device

# VGG16 "features" conv channel progression (torchvision layout); M = maxpool
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# index (into the conv list) of the last conv of each tapped block
TAP_AFTER_CONV = [1, 3, 6, 9, 12]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
N_CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _unit_normalize(x, eps=1e-10):
    """Channel-wise unit normalisation (modules/utils.py:6-8)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance of image pairs. The weights are buffers, named as the
    ``.npz`` names them (``conv{i}_w`` (out, in, 3, 3), ``conv{i}_b``,
    ``lin{k}`` (C,)); ``.double()`` gives the float64 module."""

    def __init__(self, weights: dict):
        super().__init__()
        n_conv = TAP_AFTER_CONV[-1] + 1
        for i in range(n_conv):
            self.register_buffer(f"conv{i}_w", torch.as_tensor(weights[f"conv{i}_w"]))
            self.register_buffer(f"conv{i}_b", torch.as_tensor(weights[f"conv{i}_b"]))
        for k in range(len(N_CHANNELS)):
            self.register_buffer(f"lin{k}", torch.as_tensor(weights[f"lin{k}"]))
        self.register_buffer("shift", torch.as_tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE)[None, :, None, None])

    def taps(self, x):
        """(N, 3, H, W) z-scored input -> the five tapped ReLU activations.
        Max-pooling floors odd sizes, as ``reduce_window(..., "VALID")``."""
        taps = []
        ci = 0
        for item in VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(conv2d_fp32(x, getattr(self, f"conv{ci}_w"),
                                       getattr(self, f"conv{ci}_b"), padding=(1, 1)))
            if ci in TAP_AFTER_CONV:
                taps.append(x)
            ci += 1
            if len(taps) == len(TAP_AFTER_CONV):
                break
        return taps

    def forward(self, x, y):
        """LPIPS of two (3, H, W) images in [0, 1]: a 0-d tensor. Both go
        through the network as one batch of two."""
        z = (torch.stack([x, y]).to(self.shift.dtype) - self.shift) / self.scale
        score = torch.zeros((), dtype=z.dtype, device=z.device)
        for k, t in enumerate(self.taps(z)):
            d = (_unit_normalize(t[:1]) - _unit_normalize(t[1:])) ** 2
            lin = getattr(self, f"lin{k}")
            score = score + torch.mean(torch.sum(d * lin[None, :, None, None], dim=1))
        return score


def lpips_from_arrays(arrays: dict, device=None) -> LPIPS:
    """An ``LPIPS`` on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``) from a dict of numpy weight arrays, the JAX
    package's weight dict."""
    dev = resolve_device(device)
    w = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    return LPIPS(w).to(dev).eval()


def load_weights(path: str, device=None) -> LPIPS:
    """An ``LPIPS`` from the converted weight file at ``path``; raises
    ``FileNotFoundError`` when there is none."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}. Convert them with the JAX package's "
            "scripts/convert_lpips_weights.py on a machine with network access (it needs "
            "torchvision) and pass the .npz path")
    with np.load(path) as raw:
        return lpips_from_arrays({k: raw[k] for k in raw.files}, device=device)
