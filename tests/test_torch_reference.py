"""The exact reference renderer of the port (``radegs_torch/ops/reference.py``
and ``ops/blend_math.py``) against the JAX package's
``radegs_tpu.ops.reference.render_reference`` on the same preprocess arrays
(the three seeded cases of tests/test_reference_renderer.py): every output
map, and ``jax.grad`` against ``torch.autograd`` of a seeded weighted sum of
the maps w.r.t. the nine blend inputs. Then the port's own oracle use:
``rasterize`` (the plain blend on the CPU, its hand-written backward)
against autograd through the port's reference, forward and gradients.

Tolerances. Port vs JAX: per map max |a - b| <= 1e-4 x max(1, max |JAX|),
per gradient field max |a - b| <= 1e-4 x max |JAX| (seen: 4.9e-5 and 5.2e-5
on the 32-Gaussian case). The two sides form the transmittance as
cumulative products in other orders, so a pixel whose T (1 - alpha) lies
within rounding of the 1e-4 stop flips, and moves by about 1e-4 of its
accumulators. ``rasterize`` vs the port's reference: maps within abs 1e-5,
gradients within 1e-4 x max |reference| (seen: <= 7.7e-6; both walk in
float32 in the same order of contributors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.ops.reference import render_reference as j_reference
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.projection import PreprocessOut
from radegs_torch.core.projection import preprocess_gaussians as t_preprocess
from radegs_torch.ops.rasterize import rasterize
from radegs_torch.ops.reference import render_reference as t_reference

torch.set_num_threads(1)
FIELDS = ["xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
          "normal", "ts"]
KEYS = ["render", "alpha", "expected_depth", "median_depth", "expected_coord",
        "median_coord", "normal", "accum_depth", "accum_coord", "normal_length", "t_final"]
# rasterize's maps and the reference's names for them
RASTER_KEYS = {"render": "render", "mask": "alpha", "expected_depth": "expected_depth",
               "median_depth": "median_depth", "expected_coord": "expected_coord",
               "median_coord": "median_coord", "normal": "normal"}
REL_JAX = 1e-4
ABS_RASTER, REL_RASTER = 1e-5, 1e-4


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def scene(P=32, seed=5, size=64):
    """tests/test_reference_renderer.py:scene."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, 3)).astype(np.float32) * 0.5
    q = rng.normal(size=(P, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(P, 3)) * 0.3).astype(np.float32) * 0.15
    opac = rng.uniform(0.4, 0.95, size=(P, 1)).astype(np.float32)
    sh = rng.normal(size=(P, 16, 3)).astype(np.float32) * 0.3
    return means, scales, q, opac, sh, size


def single_gaussian():
    """tests/test_reference_renderer.py:test_single_gaussian_depth_matches_center_distance."""
    return (np.array([[0.1, -0.2, 0.0]], np.float32), np.full((1, 3), 0.2, np.float32),
            np.array([[1, 0, 0, 0]], np.float32), np.array([[0.95]], np.float32),
            np.zeros((1, 16, 3), np.float32), 64)


CASES = {
    "invariants": (lambda: scene(), [1.0, 1.0, 1.0]),
    "background": (lambda: scene(P=1), [0.25, 0.5, 0.75]),
    "single_gaussian": (single_gaussian, [0.0, 0.0, 0.0]),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The JAX preprocess of a case, its reference maps, and jax.grad of a
    seeded weighted sum of all maps w.r.t. the nine blend inputs."""
    make, bg = CASES[request.param]
    means, scales, q, opac, sh, size = make()
    cam = JCamera.look_at([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 0.8, 0.8, size, size)
    prep = j_preprocess(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q),
                        jnp.asarray(opac), jnp.asarray(sh), 3, cam)
    bg = np.asarray(bg, np.float32)
    args = (cam.width, cam.height, cam.focal_x, cam.focal_y, jnp.asarray(bg))
    out = j_reference(prep, *args)
    rng = np.random.default_rng(7)
    weights = {k: rng.normal(size=np.asarray(out[k]).shape).astype(np.float32) for k in KEYS}

    def loss(fields):
        o = j_reference(prep.replace(**dict(zip(FIELDS, fields))), *args)
        return sum(jnp.vdot(weights[k], o[k]) for k in KEYS)

    grads = jax.grad(loss)(tuple(getattr(prep, f) for f in FIELDS))
    return dict(prep=prep, cam=cam, bg=bg, out=out, weights=weights, grads=grads)


def torch_prep(prep):
    """The JAX preprocess arrays as the port's PreprocessOut, the nine blend
    inputs as leaves that require grad."""

    def t(x):
        return torch.from_numpy(np.array(x))

    leaves = {f: t(getattr(prep, f)).requires_grad_(True) for f in FIELDS}
    return PreprocessOut.from_fields(t(prep.valid), t(prep.radius), t(prep.well_conditioned),
                                     **leaves), leaves


def with_fields(prep, fields):
    """``prep`` with its table packed anew from ``fields``."""
    return PreprocessOut.from_fields(prep.valid, prep.radius, prep.well_conditioned, **fields)


def test_forward_matches_jax(case):
    tp, _ = torch_prep(case["prep"])
    cam = case["cam"]
    out = t_reference(tp, cam.width, cam.height, float(cam.focal_x), float(cam.focal_y),
                      torch.from_numpy(case["bg"]))
    for k in KEYS:
        a, b = np.asarray(case["out"][k]), out[k].detach().numpy()
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= REL_JAX * max(1.0, np.abs(a).max()), k


def test_autograd_matches_jax_grad(case):
    tp, leaves = torch_prep(case["prep"])
    cam = case["cam"]
    out = t_reference(tp, cam.width, cam.height, float(cam.focal_x), float(cam.focal_y),
                      torch.from_numpy(case["bg"]))
    sum((torch.from_numpy(case["weights"][k]) * out[k]).sum() for k in KEYS).backward()
    for f, jg in zip(FIELDS, case["grads"]):
        assert rel_err(jg, leaves[f].grad.numpy()) <= REL_JAX, f
        assert np.abs(np.asarray(jg)).max() > 0, f


def raster_scene(P, seed, W, H, opacity=None):
    """tests/test_rasterize.py:make_scene through the port's preprocess;
    ``opacity`` pins every opacity (0.99 ends pixels early)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, 3)) * 0.5
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(P, 3)) * 0.4) * 0.12
    opac = rng.uniform(0.3, 0.95, size=(P, 1)) if opacity is None else np.full((P, 1), opacity)
    sh = rng.normal(size=(P, 16, 3)) * 0.3
    cam = TCamera.look_at([0.3, -0.2, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H,
                          device="cpu")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    return t_preprocess(t(means), t(scales), t(q), t(opac), t(sh), sh_degree=3, camera=cam), cam


@pytest.mark.parametrize("P, seed, W, H, opacity", [(48, 9, 64, 64, None),
                                                    (64, 21, 72, 50, 0.99)],
                         ids=["translucent", "terminating_ragged"])
def test_rasterize_matches_reference_autograd(P, seed, W, H, opacity):
    prep, cam = raster_scene(P, seed, W, H, opacity)
    bg = torch.tensor([0.3, 0.2, 0.1])
    leaves = {f: getattr(prep, f).detach().clone().requires_grad_(True) for f in FIELDS}
    out = rasterize(with_fields(prep, leaves), cam, bg, max_per_tile=256, instance_budget=1 << 14)
    assert int(out["binning"].n_overflow) == 0 and int(out["binning"].tile_overflow) == 0
    rng = np.random.default_rng(3)
    weights = {k: torch.tensor(rng.normal(size=tuple(out[k].shape)).astype(np.float32))
               for k in RASTER_KEYS}
    sum((weights[k] * out[k]).sum() for k in RASTER_KEYS).backward()

    ref_leaves = {f: getattr(prep, f).detach().clone().requires_grad_(True) for f in FIELDS}
    ref = t_reference(with_fields(prep, ref_leaves), W, H, cam.focal_x, cam.focal_y, bg)
    if opacity is not None:
        assert (ref["t_final"] < 1e-3).any()  # pixels end early
    for k, r in RASTER_KEYS.items():
        assert (out[k] - ref[r]).abs().max().item() <= ABS_RASTER, k
    sum((weights[k] * ref[r]).sum() for k, r in RASTER_KEYS.items()).backward()
    for f in FIELDS:
        a, b = ref_leaves[f].grad.numpy(), leaves[f].grad.numpy()
        assert rel_err(a, b) <= REL_RASTER, f
        assert np.abs(a).max() > 0, f
