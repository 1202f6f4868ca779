"""Alpha-blending math of the exact reference renderer (port of
``radegs_tpu/ops/blend_math.py``; semantics of cuda_rasterizer/forward.cu:
428-693, renderCUDA), in a parallel form: alpha and transmittance for all
contributors of a pixel at once, through an exclusive cumulative product,
instead of the sequential front-to-back loop. The sequential rules hold
exactly:

- power > 0 -> skipped (forward.cu:556-558);
- alpha = min(0.99, op exp(power)) < 1/255 -> skipped (forward.cu:565-567);
- the first contributor where T (1 - alpha) < 1e-4 ends the pixel; it and
  everything behind it are excluded (forward.cu:568-573).

T falls only through included contributors, so the cumulative product over
the candidates' alphas is the sequential T at every index up to the one
that ends the pixel. No code is shared with the blend walk of
``ops/blend.py``: this is the independent oracle for both blends.
"""

from __future__ import annotations

import torch

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
NORMALIZE_EPS = 1e-12  # auxiliary.h:23


def gaussian_alpha(xy, conic, opacity, pix):
    """Per (Gaussian, pixel) alpha and candidacy. ``xy`` (..., 2) projected
    centres, ``conic`` (..., 3), ``opacity`` (...,), ``pix`` (..., 2) pixel
    coordinates broadcastable against ``xy``. Returns (alpha, candidate)
    with alpha zeroed where the contributor is no candidate."""
    d = xy - pix
    dx, dy = d[..., 0], d[..., 1]
    power = (-0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy)
             - conic[..., 1] * dx * dy)
    alpha = torch.clamp_max(opacity * torch.exp(torch.clamp_max(power, 0.0)), MAX_ALPHA)
    candidate = (power <= 0.0) & (alpha >= ALPHA_EPS)
    return torch.where(candidate, alpha, 0.0), candidate


def transmittance_weights(alpha, dim: int = 0):
    """From depth-ordered alphas (zeros for skipped contributors) along
    ``dim``: ``include`` (blended, before the pixel ends), the weights
    ``w`` = alpha T, ``t_prefix`` (T before each contributor) and
    ``t_final`` (T after the last included one)."""
    one_minus = 1.0 - alpha
    # exclusive product: exact division, since alpha <= 0.99 keeps one_minus >= 0.01
    t_prefix = torch.cumprod(one_minus, dim=dim) / one_minus
    terminate = (alpha > 0.0) & (t_prefix * one_minus < T_EPS)
    kill = torch.cumsum(terminate.to(torch.int32), dim=dim) > 0  # inclusive
    include = (alpha > 0.0) & ~kill
    w = torch.where(include, alpha * t_prefix, 0.0)
    t_final = torch.prod(torch.where(include, one_minus, 1.0), dim=dim)
    return include, w, t_prefix, t_final
