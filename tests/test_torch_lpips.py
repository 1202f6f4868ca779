"""LPIPS on the port (``radegs_torch/eval/lpips.py``) against the JAX
package's ``lpips_pair`` with ``tests/test_lpips.py``'s random weights
(scale 0.3), carried across as numpy arrays by ``lpips_from_arrays``.

Tolerances: rtol 1e-4 / atol 1e-6 on the score (float32 convolutions
summed in another order by XLA and by PyTorch), at 32x48 and at 50x72,
whose pooling floors odd sizes (50 -> 25 -> 12, 72 -> 36 -> 18 -> 9 -> 4);
``load_weights`` of a written ``.npz`` equals ``lpips_from_arrays`` bit for
bit. On a card, the float32 score against the same module in float64, and
unchanged with TF32 allowed by the caller. JAX is imported only by the
parity test, so the ``cuda`` test runs on the card with
``python -m pytest --noconftest -q -m cuda tests/test_torch_lpips.py``.
"""

import numpy as np
import pytest
import torch

from radegs_torch.eval.lpips import N_CHANNELS, VGG16_CFG, load_weights, lpips_from_arrays

torch.set_num_threads(1)


def random_weights(scale=0.3, seed=7):
    """tests/test_lpips.py's random weights (its first draw from its seed)."""
    rng = np.random.default_rng(seed)
    w, cin, ci = {}, 3, 0
    for item in VGG16_CFG:
        if item == "M":
            continue
        w[f"conv{ci}_w"] = rng.normal(size=(item, cin, 3, 3)).astype(np.float32) * scale
        w[f"conv{ci}_b"] = rng.normal(size=(item,)).astype(np.float32) * scale
        cin, ci = item, ci + 1
    for k, c in enumerate(N_CHANNELS):
        w[f"lin{k}"] = np.abs(rng.normal(size=(c,)).astype(np.float32))
    return w


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(size=shape).astype(np.float32) * 0.1, 0, 1)
    return x, y


@pytest.fixture(scope="module")
def weights():
    return random_weights(scale=0.3)


@pytest.mark.parametrize("shape", [(3, 32, 48), (3, 50, 72)], ids=["32x48", "50x72"])
def test_lpips_matches_jax(weights, shape):
    import jax.numpy as jnp

    from radegs_tpu.eval.lpips import lpips_pair

    x, y = pair(shape, 1)
    want = float(lpips_pair(jnp.asarray(x), jnp.asarray(y),
                            {k: jnp.asarray(v) for k, v in weights.items()}))
    model = lpips_from_arrays(weights, device="cpu")
    with torch.no_grad():
        got = float(model(torch.from_numpy(x), torch.from_numpy(y)))
        same = float(model(torch.from_numpy(x), torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6), (got, want)
    assert same == 0.0 and got > 0


def test_load_weights_equals_arrays_and_missing_raises(weights, tmp_path):
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **weights)
    a = lpips_from_arrays(weights, device="cpu")
    b = load_weights(path, device="cpu")
    assert a.state_dict().keys() == b.state_dict().keys()
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    x, y = pair((3, 32, 48), 2)
    with torch.no_grad():
        assert torch.equal(a(torch.from_numpy(x), torch.from_numpy(y)),
                           b(torch.from_numpy(x), torch.from_numpy(y)))
    with pytest.raises(FileNotFoundError, match="LPIPS weights not found"):
        load_weights(str(tmp_path / "missing.npz"), device="cpu")


@pytest.mark.cuda
def test_lpips_on_the_card_float32_and_tf32_pin(weights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = (torch.from_numpy(a).cuda() for a in pair((3, 120, 160), 3))
    model = lpips_from_arrays(weights, device="cuda")
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        with torch.no_grad():
            torch.backends.cudnn.allow_tf32 = False
            pinned = model(x, y)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            allowed = model(x, y)
            f64 = model.double()(x.double(), y.double())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(pinned, allowed)
    assert float(pinned) == pytest.approx(float(f64), rel=1e-4)
