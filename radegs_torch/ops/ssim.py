"""SSIM and L1 losses (port of ``radegs_tpu/ops/ssim.py``; reference
utils/loss_utils.py:17-63): the 11-tap Gaussian window (sigma 1.5), applied
per channel and separably, with zero ("same") padding.

The JAX package writes the filter as shifted multiply-adds for the TPU;
here it is two depthwise convolutions over the five filtered maps at once,
through ``ops.conv.conv2d_fp32``: float32 on the card whatever
``torch.backends.cudnn.allow_tf32`` says (cuDNN would run them in TF32 by
default), as the JAX package's filter is."""

from __future__ import annotations

import numpy as np
import torch

from radegs_torch.ops.conv import conv2d_fp32
from radegs_torch.utils import trace

C1 = 0.01**2
C2 = 0.03**2


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def psnr(a, b):
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(mse)


def _gaussian_taps(size: int = 11, sigma: float = 1.5):
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(maps, taps):
    """Separable depthwise 'same' Gaussian filter of (C, H, W) maps."""
    C = maps.shape[0]
    k = taps.shape[0]
    with trace.sync("ssim.taps"):  # a copy from pageable host memory
        w = torch.as_tensor(taps, dtype=maps.dtype, device=maps.device)
    x = conv2d_fp32(maps[None], w.reshape(1, 1, k, 1).expand(C, 1, k, 1),
                    padding=(k // 2, 0), groups=C)
    x = conv2d_fp32(x, w.reshape(1, 1, 1, k).expand(C, 1, 1, k), padding=(0, k // 2),
                    groups=C)
    return x[0]


def ssim_map(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Per-pixel SSIM map (C, H, W) with 'same' zero padding."""
    C = img1.shape[0]
    taps = _gaussian_taps(window_size, sigma)
    f = _filter2d(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2]), taps)
    mu1, mu2 = f[:C], f[C:2 * C]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f[2 * C:3 * C] - mu1_sq
    s2 = f[3 * C:4 * C] - mu2_sq
    s12 = f[4 * C:] - mu12
    return ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over a (C, H, W) image pair (utils/loss_utils.py:23-63)."""
    return torch.mean(ssim_map(img1, img2, window_size, sigma))
