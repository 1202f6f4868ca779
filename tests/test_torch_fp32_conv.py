"""The port's convolutions stay float32 on the card: ``ops.conv.conv2d_fp32``
behind the SSIM filter (``ops/ssim.py``) and the appearance network
(``models/appearance.py``), forward and backward, whatever
``torch.backends.cudnn.allow_tf32`` says (cuDNN runs float32 convolutions in
TF32 by default). Torch only, so the card's machine runs it too:
``python -m pytest tests/test_torch_fp32_conv.py`` (the ``cuda`` tests skip
without a card).

Tolerances: SSIM within abs 1e-6 of the float64 filter and its input
gradient within 1e-5 x max |float64| (the float32 CPU filter: 2.0e-8 and
8.4e-7); the appearance transform, its input gradient and its parameters'
gradients within 1e-4 x max |float64| (float32 CPU: 1.4e-7, 1.6e-7, 2.3e-6;
cuDNN's float32 algorithms may use Winograd or FFT transforms). TF32 keeps
about three decimal digits, ~1e-3 of these quantities.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radegs_torch.models.appearance import appearance_transform, init_appearance
from radegs_torch.ops.conv import conv2d_fp32
from radegs_torch.ops.ssim import ssim

torch.set_num_threads(1)
SSIM_ABS, SSIM_GRAD_REL = 1e-6, 1e-5
APP_REL = 1e-4


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def images(seed=0, shape=(3, 96, 128)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape)
    return a, np.clip(a + rng.normal(scale=0.1, size=shape), 0.0, 1.0)


def ssim_and_grad(a, b, dtype, device):
    x = torch.tensor(a, dtype=dtype, device=device, requires_grad=True)
    s = ssim(x, torch.tensor(b, dtype=dtype, device=device))
    s.backward()
    return s.item(), x.grad.cpu().numpy()


def appearance_and_grads(dtype, device):
    """The appearance transform of a seeded image (view 3), its input
    gradient and its network parameters' gradients under seeded weights."""
    _, app = init_appearance(torch.Generator().manual_seed(0))
    params = {"net": {k: v.to(device, dtype).requires_grad_(True)
                      for k, v in app["net"].items()},
              "embeddings": app["embeddings"].to(device, dtype)}
    img = np.random.default_rng(1).uniform(size=(3, 96, 128))
    x = torch.tensor(img, dtype=dtype, device=device, requires_grad=True)
    out, _ = appearance_transform(params, x, 3)
    w = np.random.default_rng(2).normal(size=tuple(out.shape))
    (out * torch.tensor(w, dtype=dtype, device=device)).sum().backward()
    return (out.detach().cpu().numpy(), x.grad.cpu().numpy(),
            {k: v.grad.cpu().numpy() for k, v in params["net"].items()})


@pytest.mark.parametrize("groups, padding", [(15, (5, 0)), (1, (1, 1))],
                         ids=["depthwise_ssim", "dense_appearance"])
def test_conv2d_fp32_equals_conv2d_on_cpu(groups, padding):
    rng = np.random.default_rng(4)
    cin = 15 if groups == 15 else 8
    kh, kw = (11, 1) if groups == 15 else (3, 3)
    x0 = torch.tensor(rng.normal(size=(1, cin, 24, 20)), dtype=torch.float32)
    w0 = torch.tensor(rng.normal(size=(cin if groups == 15 else 6, cin // groups, kh, kw)),
                      dtype=torch.float32)
    b0 = torch.tensor(rng.normal(size=(w0.shape[0],)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(1, w0.shape[0], 24, 20)), dtype=torch.float32)
    outs = []
    for conv in (conv2d_fp32, F.conv2d):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = conv(x, w, b, padding=padding, groups=groups)
        y.backward(g)
        outs.append((y, x.grad, w.grad, b.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ssim_float32_matches_float64_on_cpu():
    a, b = images()
    s32, g32 = ssim_and_grad(a, b, torch.float32, "cpu")
    s64, g64 = ssim_and_grad(a, b, torch.float64, "cpu")
    assert abs(s32 - s64) <= SSIM_ABS
    assert rel_err(g32, g64) <= SSIM_GRAD_REL


def test_appearance_float32_matches_float64_on_cpu():
    out, gx, gp = appearance_and_grads(torch.float32, "cpu")
    out64, gx64, gp64 = appearance_and_grads(torch.float64, "cpu")
    assert rel_err(out, out64) <= APP_REL
    assert rel_err(gx, gx64) <= APP_REL
    for k in gp64:
        assert rel_err(gp[k], gp64[k]) <= APP_REL, k


@pytest.mark.cuda
def test_ssim_on_card_is_float32_with_tf32_allowed():
    """A guard, not a witness of the TF32 fault: cuDNN's depthwise
    convolutions have not been seen to use TF32 (the card's SSIM agreed with
    float64 through plain ``F.conv2d`` too), so this holds the SSIM to
    float32 against a later cuDNN algorithm choice. The appearance test
    below is the one that separates pinned from unpinned convolutions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's TF32 exists only there")
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default, left as it is
    a, b = images()
    s, g = ssim_and_grad(a, b, torch.float32, "cuda")
    s64, g64 = ssim_and_grad(a, b, torch.float64, "cpu")
    assert torch.backends.cudnn.allow_tf32  # restored after the forward and backward
    assert abs(s - s64) <= SSIM_ABS
    assert rel_err(g, g64) <= SSIM_GRAD_REL


@pytest.mark.cuda
def test_appearance_on_card_is_float32_with_tf32_allowed():
    """The witness of the TF32 fault: through plain ``F.conv2d`` with TF32
    allowed the parameters' gradients were 2.7e-4 x max |float64| off,
    beyond APP_REL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's TF32 exists only there")
    assert torch.backends.cudnn.allow_tf32
    out, gx, gp = appearance_and_grads(torch.float32, "cuda")
    out64, gx64, gp64 = appearance_and_grads(torch.float64, "cpu")
    assert torch.backends.cudnn.allow_tf32
    assert rel_err(out, out64) <= APP_REL
    assert rel_err(gx, gx64) <= APP_REL
    for k in gp64:
        assert rel_err(gp[k], gp64[k]) <= APP_REL, k
