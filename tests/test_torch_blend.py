"""The forward blend: the port's plain version ``blend_forward_torch``
against the JAX package's XLA scan and both Pallas kernels (interpret mode)
on the same binning, and the CUDA kernel against the plain version on a card.

Tolerance: abs 1e-5 for the float accumulators (the JAX suite's own bound,
tests/test_pallas_blend.py:56 — the JAX side forms transmittance as chunked
cumulative products, the port multiplies one contributor at a time);
``med_pos`` must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.ops.binning import bin_gaussians as j_bin
from radegs_tpu.ops.pallas_blend import blend_forward_pallas
from radegs_tpu.ops.pallas_blend_mt import blend_forward_pallas_mt
from radegs_tpu.ops.rasterize import RasterCfg, _blend_forward_scan
from radegs_torch.core.projection import pack_table
from radegs_torch.ops import blend
from radegs_torch.ops.binning import bin_gaussians as t_bin

torch.set_num_threads(1)
W, H = 72, 50  # not a multiple of 16: the ragged tiles are blended too


def table_of(inputs):
    """The nine blend inputs as the port's per-Gaussian table."""
    xy, conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts = inputs
    return pack_table(xy=xy, conic=conic, opacity=opacity, rgb=rgb, ts=ts, ray_plane=ray_plane,
                      view_point=view_point, camera_plane=camera_plane, normal=normal)


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
                    instance_budget=1 << 11, max_per_tile=128, conic=prep.conic,
                    opacity=j_inputs[2])
    t_inputs = tuple(torch.from_numpy(np.array(x)) for x in j_inputs)
    port = blend.blend_forward_torch(torch.from_numpy(np.array(binning.tile_gauss)),
                                     table_of(t_inputs), W, H, count_work=True)
    return prep, binning, j_inputs, t_inputs, port


def reference(kind, binning, j_inputs):
    if kind == "xla_scan":
        return _blend_forward_scan(RasterCfg(width=W, height=H), binning.tile_gauss, j_inputs)
    if kind == "pallas":
        return blend_forward_pallas(binning, *j_inputs, width=W, height=H, chunk=16,
                                    interpret=True)
    return blend_forward_pallas_mt(binning, *j_inputs, width=W, height=H, chunk=16,
                                   gbatch=2, interpret=True)


@pytest.mark.parametrize("kind", ["xla_scan", "pallas", "pallas_mt_g2"])
def test_plain_blend_matches_jax(scene, kind):
    _, binning, j_inputs, _, port = scene
    ref = reference(kind, binning, j_inputs)
    for k, v in ref.items():
        a, b = np.asarray(v), port[k].numpy()
        assert a.shape == b.shape, k
        if k == "med_pos":
            assert (a == b).all()
        else:
            assert np.abs(a - b).max() <= 1e-5, (k, np.abs(a - b).max())
    # the scene exercises termination, medians and empty tiles
    assert (port["t_final"].numpy() < 1e-3).any()
    assert (port["med_pos"].numpy() >= 0).any()
    assert (port["weight"].numpy() == 0).any()
    assert 0 < int(port["n_incl"]) < int(port["n_eval"])


def test_blend_forward_on_cpu_runs_the_plain_version(scene):
    prep, _, _, t_inputs, port = scene
    tb = t_bin(*(torch.from_numpy(np.array(x)) for x in
                 (prep.xy, prep.radius, prep.depth, prep.valid)), W, H,
               instance_budget=1 << 11, max_per_tile=128, conic=t_inputs[1],
               opacity=t_inputs[2], need_tile_gauss=True)
    before = dict(blend.LAUNCHES)
    out = blend.blend_forward(tb, table_of(t_inputs), W, H)
    assert blend.LAUNCHES == before  # no kernel launch counted on the CPU
    for k, v in out.items():
        assert torch.equal(v, port[k]), k
    with pytest.raises(ValueError, match="tile_gauss"):
        blend.blend_forward(tb._replace(tile_gauss=None), table_of(t_inputs), W, H)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles_per_block", [1, 2])
def test_kernel_matches_plain_on_card(scene, tiles_per_block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blend kernel has no CPU mode")
    prep, _, _, t_inputs, _ = scene
    dev = torch.device("cuda")
    inputs = tuple(x.to(dev) for x in t_inputs)
    tb = t_bin(*(torch.from_numpy(np.array(x)).to(dev) for x in
                 (prep.xy, prep.radius, prep.depth, prep.valid)), W, H,
               instance_budget=1 << 11, max_per_tile=128, conic=inputs[1],
               opacity=inputs[2], need_tile_gauss=True)
    plain = blend.blend_forward_torch(tb.tile_gauss, table_of(inputs), W, H)
    out = blend.blend_forward(tb, table_of(inputs), W, H, tiles_per_block=tiles_per_block)
    torch.cuda.synchronize()
    for k, v in plain.items():
        if k == "med_pos":
            assert (out[k] != v).float().mean().item() <= 1e-3
        else:
            # different summation order and FMA contraction on the card
            assert (out[k] - v).abs().max().item() <= 1e-4, k
