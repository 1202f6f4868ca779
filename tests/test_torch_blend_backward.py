"""The backward blend: the port's plain version ``blend_backward_torch``
against the JAX package's XLA scan (``_blend_backward_scan``) and both
Pallas backward kernels in interpret mode (``blend_backward_pallas``,
``blend_backward_pallas_mt`` at two tiles per program), on the same JAX
binning, forward totals and seeded random cotangents; a second oracle is
``torch.autograd`` through ``blend_forward_torch``. The CUDA kernel is held
against the plain version on a card.

Tolerance: rel 1e-5 per field, max |a - b| / max |a| (the JAX suite's own
bound, tests/test_pallas_blend.py:78,94: the sides sum in other orders and
the JAX scan forms transmittance as chunked cumulative products). On the card
rel 1e-4 per field (the kernel's pixel sums are a warp tree), G=1 and G=2
bit-identical, two runs bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.ops.binning import bin_gaussians as j_bin
from radegs_tpu.ops.pallas_blend import blend_backward_pallas
from radegs_tpu.ops.pallas_blend_mt import blend_backward_pallas_mt
from radegs_tpu.ops.rasterize import RasterCfg, _blend_backward_scan, _blend_forward_scan
from radegs_torch.core.projection import COLUMNS, column, pack_table
from radegs_torch.ops import blend
from radegs_torch.ops.binning import bin_gaussians as t_bin

torch.set_num_threads(1)
W, H = 72, 50  # not a multiple of 16: ragged tiles
MAX_PER_TILE = 64  # below the longest runs (104): the cut drops 65 instances
REL = 1e-5
GRADS = ["xy", "xy_abs", "conic", "opacity", "rgb", "view_point", "camera_plane",
         "ray_plane", "normal", "ts"]


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def table_of(inputs):
    """The nine blend inputs as the port's per-Gaussian table."""
    xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts = inputs
    return pack_table(xy=xy, conic=conic, opacity=opacity, rgb=rgb, ts=ts, ray_plane=ray_plane,
                      view_point=view_point, camera_plane=camera_plane, normal=normal)


def fields_of(grad):
    """The gradient buffer as per-field views: the table's fields, xy_abs
    (P, 2)."""
    return {**{f: column(grad, f) for f in COLUMNS}, "xy_abs": grad[:, blend.XY_ABS:]}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    P = 120
    cam = JCamera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H)
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    prep = j_preprocess(
        jnp.asarray(rng.normal(size=(P, 3)) * 0.5 + [0.5, 0, 0], jnp.float32),
        jnp.asarray(np.exp(rng.normal(size=(P, 3)) * 0.4 - 1.8), jnp.float32),
        jnp.asarray(q, jnp.float32),
        jnp.asarray(rng.uniform(0.3, 0.99, (P, 1)), jnp.float32),
        jnp.asarray(rng.uniform(0.1, 0.9, size=(P, 1, 3)), jnp.float32),
        sh_degree=0, camera=cam, kernel_size=0.1,
    )
    j_inputs = (prep.xy, prep.conic, jnp.where(prep.valid, prep.opacity, 0.0), prep.rgb,
                prep.view_point, prep.camera_plane, prep.ray_plane, prep.normal, prep.ts)
    binning = j_bin(prep.xy, prep.radius, prep.depth, prep.valid, W, H,
                    instance_budget=1 << 11, max_per_tile=MAX_PER_TILE, conic=prep.conic,
                    opacity=j_inputs[2])
    fwd = _blend_forward_scan(RasterCfg(width=W, height=H), binning.tile_gauss, j_inputs)
    crng = np.random.default_rng(5)
    j_cot = {k: jnp.asarray(crng.normal(size=fwd[k].shape), jnp.float32)
             for k in blend.DIFF_KEYS}
    t_inputs = tuple(torch.from_numpy(np.array(x)) for x in j_inputs)
    t_fwd = {k: torch.from_numpy(np.array(v)) for k, v in fwd.items()}
    t_cot = {k: torch.from_numpy(np.array(v)) for k, v in j_cot.items()}
    tile_gauss = torch.from_numpy(np.array(binning.tile_gauss))
    buf = blend.blend_backward_torch(tile_gauss, table_of(t_inputs), t_fwd, t_cot, W, H)
    return dict(prep=prep, binning=binning, j_inputs=j_inputs, fwd=fwd, j_cot=j_cot,
                t_inputs=t_inputs, t_fwd=t_fwd, t_cot=t_cot, tile_gauss=tile_gauss,
                port=fields_of(buf), buf=buf)


def test_scene_exercises_every_branch(scene):
    fwd, binning = scene["fwd"], scene["binning"]
    assert (np.asarray(fwd["t_final"]) < 1e-3).any()  # pixels terminate
    assert (np.asarray(fwd["med_pos"]) >= 0).any()  # medians
    assert (np.asarray(binning.tile_count) == 0).any()  # empty tiles
    assert int(binning.tile_overflow) > 0  # the max_per_tile cut


@pytest.mark.parametrize("kind", ["xla_scan", "pallas", "pallas_mt_g2"])
def test_plain_backward_matches_jax(scene, kind):
    args = (scene["binning"], scene["j_inputs"], scene["fwd"], scene["j_cot"])
    if kind == "xla_scan":
        ref = _blend_backward_scan(RasterCfg(width=W, height=H, chunk=16),
                                   scene["binning"].tile_gauss, *args[1:])
    elif kind == "pallas":
        ref = blend_backward_pallas(*args, width=W, height=H, chunk=16, interpret=True)
    else:
        ref = blend_backward_pallas_mt(*args, width=W, height=H, chunk=16, gbatch=2,
                                       interpret=True)
    for k in GRADS:
        assert rel_err(ref[k], scene["port"][k].numpy()) <= REL, k
    assert np.abs(np.asarray(ref["xy_abs"])).max() > 0


def test_plain_backward_matches_autograd(scene):
    """torch.autograd through the plain forward gives the exact gradient of
    the same sequential computation (everything but the xy_abs side channel)."""
    inputs = tuple(x.clone().requires_grad_(True) for x in scene["t_inputs"])
    out = blend.blend_forward_torch(scene["tile_gauss"], table_of(inputs), W, H)
    loss = sum((out[k] * scene["t_cot"][k]).sum() for k in blend.DIFF_KEYS)
    loss.backward()
    names = ["xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
             "normal", "ts"]
    for name, x in zip(names, inputs):
        assert rel_err(x.grad.numpy(), scene["port"][name].numpy()) <= REL, name


def test_plain_backward_buffer_is_the_table_gradient(scene):
    """The plain backward's (P, GRAD_COLS) buffer is autograd's gradient of
    the packed table through the plain forward, in the table's column order,
    with xy_abs after it (the XLA scan's) and a zero column."""
    table = table_of(scene["t_inputs"]).requires_grad_(True)
    out = blend.blend_forward_torch(scene["tile_gauss"], table, W, H)
    sum((out[k] * scene["t_cot"][k]).sum() for k in blend.DIFF_KEYS).backward()
    buf = scene["buf"]
    assert buf.shape == (table.shape[0], blend.GRAD_COLS) == (table.shape[0], 26)
    for c in range(blend.XY_ABS):
        assert rel_err(table.grad[:, c].numpy(), buf[:, c].numpy()) <= REL, c
    ref = _blend_backward_scan(RasterCfg(width=W, height=H, chunk=16),
                               scene["binning"].tile_gauss, scene["j_inputs"], scene["fwd"],
                               scene["j_cot"])
    assert rel_err(np.asarray(ref["xy_abs"])[:, 0], buf[:, blend.XY_ABS].numpy()) <= REL
    assert (buf[:, blend.XY_ABS + 1] == 0).all()


def test_blend_backward_on_cpu_runs_the_plain_version(scene):
    prep = scene["prep"]
    t_inputs = scene["t_inputs"]
    tb = t_bin(*(torch.from_numpy(np.array(x)) for x in
                 (prep.xy, prep.radius, prep.depth, prep.valid)), W, H,
               instance_budget=1 << 11, max_per_tile=MAX_PER_TILE, conic=t_inputs[1],
               opacity=t_inputs[2], need_tile_gauss=True)
    assert torch.equal(tb.tile_gauss, scene["tile_gauss"])
    before = dict(blend.LAUNCHES)
    got = fields_of(blend.blend_backward(tb, table_of(t_inputs), scene["t_fwd"],
                                         scene["t_cot"], W, H))
    assert blend.LAUNCHES == before  # no kernel launch counted on the CPU
    for k in GRADS:
        assert torch.equal(got[k], scene["port"][k]), k
    with pytest.raises(ValueError, match="tile_gauss"):
        blend.blend_backward(tb._replace(tile_gauss=None), table_of(t_inputs), scene["t_fwd"],
                             scene["t_cot"], W, H)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    prep = scene["prep"]
    dev = torch.device("cuda")
    inputs = tuple(x.to(dev) for x in scene["t_inputs"])
    table = table_of(inputs)
    tb = t_bin(*(torch.from_numpy(np.array(x)).to(dev) for x in
                 (prep.xy, prep.radius, prep.depth, prep.valid)), W, H,
               instance_budget=1 << 11, max_per_tile=MAX_PER_TILE, conic=inputs[1],
               opacity=inputs[2], need_tile_gauss=True)
    fwd = blend.blend_forward(tb, table, W, H)
    cot = {k: v.to(dev) for k, v in scene["t_cot"].items()}
    plain = fields_of(blend.blend_backward_torch(tb.tile_gauss, table, fwd, cot, W, H))
    k1, k2, k2b = (fields_of(blend.blend_backward(tb, table, fwd, cot, W, H, tiles_per_block=g))
                   for g in (1, 2, 2))
    torch.cuda.synchronize()
    for k in GRADS:
        assert torch.equal(k1[k], k2[k]) and torch.equal(k2[k], k2b[k]), k
        assert rel_err(plain[k].cpu().numpy(), k2[k].cpu().numpy()) <= 1e-4, k
