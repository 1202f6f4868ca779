"""A float32 2D convolution that stays float32 on the card.

cuDNN runs a float32 convolution in TF32 (about three decimal digits)
while ``torch.backends.cudnn.allow_tf32`` is True, PyTorch's default, and
autograd reads that setting again when it runs the backward. The JAX
package's SSIM filter and appearance network are exact float32, so the
port's convolutions go through ``conv2d_fp32``: an autograd Function whose
forward and backward both run with TF32 off, and restore the caller's
setting. On the CPU the setting is never read and the result equals
``F.conv2d`` and its autograd backward bit for bit.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN convolutions in full float32 inside the block."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv2dFP32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (padding, groups, bias is not None)
        with cudnn_fp32():
            return F.conv2d(x, weight, bias, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        padding, groups, has_bias = ctx.geometry
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        with cudnn_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None, [1, 1],
                list(padding), [1, 1], False, [0, 0], groups,
                [need_x, need_w, has_bias and need_b])
        return gx, gw, gb, None, None


def conv2d_fp32(x, weight, bias=None, padding=(0, 0), groups: int = 1):
    """``F.conv2d(x, weight, bias, padding=padding, groups=groups)`` (stride
    and dilation 1, ``padding`` a pair of ints) in float32 on the card,
    forward and backward."""
    return _Conv2dFP32.apply(x, weight, bias, tuple(padding), groups)
