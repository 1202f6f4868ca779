"""Gradients of the port's differentiable rasterizer against ``jax.grad`` of
the JAX package (XLA backend) on the same numpy inputs: the weighted sum of
all seven render outputs of tests/test_pallas_blend.py:63-70, first through
``rasterize`` w.r.t. the nine preprocess fields, then end to end through
``render`` w.r.t. the six Gaussian parameters.

Tolerance: rel 1e-4 per field, max |a - b| / max |a| (float32 through other
summation orders in preprocess, blend and normalisation). The scene holds 8
flat Gaussians (one scale 1e-5, rows 12-19 of 150: ill-conditioned, their
normal and planes come from the smallest axis) and 10 inactive slots. No
row is excluded: unlike ``invraycov`` in
test_torch_core.py::test_preprocess_every_field, the flat rows' gradients
meet the tolerance (rel ~1e-6 on those rows alone), and they are also held
to the tolerance on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.ops.rasterize import rasterize as j_rasterize
from radegs_tpu.renderer import render as j_render
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.projection import PreprocessOut
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.ops.rasterize import rasterize as t_rasterize
from radegs_torch.renderer import render as t_render

torch.set_num_threads(1)
REL = 1e-4
CAM = ([0.3, -0.4, -3.8], [0.1, 0, 0], [0, 1, 0], 0.85, 0.7, 72, 50)
FIELDS = ["xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
          "normal", "ts"]
PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]
FLAT = slice(12, 20)  # ill-conditioned (flat) rows
KW = dict(max_per_tile=128, instance_budget=1 << 12)


def weighted(out, np_like):
    """The seven render outputs' weighted sum (test_pallas_blend.py:63-70)."""
    s = np_like.sum
    return (s(out["render"]) + 0.7 * s(out["expected_depth"]) + 0.3 * s(out["median_depth"])
            + 0.2 * s(out["expected_coord"]) + 0.11 * s(out["median_coord"])
            + 0.23 * s(out["normal"]) + 0.41 * s(out["mask"]))


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def random_state(seed=3, P=150, capacity=160):
    """A seeded SH-degree-3 JAX state: random rotations, 8 flat Gaussians,
    10 inactive slots, no 3D filter (so the flat rows stay flat)."""
    rng = np.random.default_rng(seed)
    js = jgm.empty_state(capacity, 3)
    scaling = rng.normal(size=(capacity, 3)) * 0.4 - 2.3
    scaling[FLAT, 0] = np.log(1e-5)
    p = js.params.replace(
        xyz=jnp.asarray(rng.normal(size=(capacity, 3)) * 0.7, jnp.float32),
        f_dc=jnp.asarray(rng.normal(size=(capacity, 1, 3)) * 0.8, jnp.float32),
        f_rest=jnp.asarray(rng.normal(size=(capacity, 15, 3)) * 0.1, jnp.float32),
        scaling=jnp.asarray(scaling, jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=(capacity, 1)) + 0.5, jnp.float32),
    )
    return js.replace(params=p, active=jnp.asarray(np.arange(capacity) < P),
                      active_sh_degree=jnp.asarray(3, jnp.int32))


def carry(js):
    p = js.params
    return tgm.state_from_arrays(
        *(np.asarray(getattr(p, k)) for k in ["xyz", "f_dc", "f_rest", "scaling",
                                               "rotation", "opacity"]),
        np.asarray(js.active), np.asarray(js.filter_3d), int(js.active_sh_degree),
        js.max_sh_degree, device="cpu")


def test_rasterize_grad_matches_jax():
    js = random_state()
    jc = JCamera.look_at(*CAM)
    scales, opac = js.get_fused_scaling_opacity()
    prep = j_preprocess(js.params.xyz, scales, js.get_rotation(),
                        jnp.where(js.active[:, None], opac, 0.0), js.get_features(),
                        sh_degree=3, camera=jc, kernel_size=0.1, active_sh_degree=3)
    prep = prep.replace(valid=prep.valid & js.active)
    bg = jnp.asarray([0.2, 0.1, 0.4])

    def j_loss(fvals):
        return weighted(j_rasterize(prep.replace(**dict(zip(FIELDS, fvals))), jc, bg,
                                    backend="xla", **KW), jnp)

    j_grads = jax.jit(jax.grad(j_loss))(tuple(getattr(prep, f) for f in FIELDS))

    def t(x):
        return torch.from_numpy(np.array(x))

    leaves = {f: t(getattr(prep, f)).requires_grad_(True) for f in FIELDS}
    t_prep = PreprocessOut.from_fields(t(prep.valid), t(prep.radius),
                                       t(prep.well_conditioned), **leaves)
    out = t_rasterize(t_prep, TCamera.look_at(*CAM, device="cpu"), t(bg), **KW)
    weighted(out, torch).backward()
    for f, jg in zip(FIELDS, j_grads):
        assert rel_err(jg, leaves[f].grad.numpy()) <= REL, f
        assert np.abs(np.asarray(jg)).max() > 0, f


@jax.jit
def j_render_grads(js, bg):
    """jax.grad of the weighted outputs of the JAX render w.r.t. the params
    (compiled once for both backgrounds)."""

    def j_loss(params):
        return weighted(j_render(js.replace(params=params), JCamera.look_at(*CAM), bg,
                                 backend="xla", kernel_size=0.1, **KW), jnp)

    return jax.grad(j_loss)(js.params)


@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0), (0.2, 0.1, 0.4)])
def test_render_grad_matches_jax(bg):
    js = random_state()
    j_grads = j_render_grads(js, jnp.asarray(bg, jnp.float32))
    ts = carry(js)
    params = ts.params.map(lambda x: x.clone().requires_grad_(True))
    out = t_render(ts.replace(params=params), TCamera.look_at(*CAM, device="cpu"), bg,
                   device="cpu", kernel_size=0.1, **KW)
    weighted(out, torch).backward()
    for name in PARAMS:
        a, b = np.asarray(getattr(j_grads, name)), getattr(params, name).grad.numpy()
        assert rel_err(a, b) <= REL, name
        assert rel_err(a[FLAT], b[FLAT]) <= REL, name
        assert np.abs(a[FLAT]).max() > 0, name
