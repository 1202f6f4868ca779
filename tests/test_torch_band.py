"""Band mode of the port's rasterizer (``render_width``, ``render_height``,
``band_row0``: one horizontal band of tile rows, as each rank of the
multi-rank step renders it) against the JAX package's band mode (XLA
backend) on the same preprocess arrays, and against the rows of the port's
own full render.

Tolerances: the seven outputs abs 1e-5 against JAX (the forward's other
summation order), gradients of their weighted sum rel 1e-4 per field (as
test_torch_rasterize_grad.py); against the full render's rows abs 1e-6
(each pixel blends the same contributors in the same order; the band only
moves the tile grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.ops.rasterize import rasterize as j_rasterize
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.projection import PreprocessOut
from radegs_torch.ops.rasterize import rasterize as t_rasterize
from test_torch_rasterize_grad import CAM, FIELDS, random_state, rel_err, weighted

torch.set_num_threads(1)
KW = dict(max_per_tile=128, instance_budget=1 << 12)
MAPS = ["render", "mask", "expected_depth", "median_depth", "expected_coord", "median_coord",
        "normal"]
W, H = CAM[-2], CAM[-1]  # 72 x 50
BG = (0.2, 0.1, 0.4)


@pytest.fixture(scope="module")
def scene():
    js = random_state()
    jc = JCamera.look_at(*CAM)
    scales, opac = js.get_fused_scaling_opacity()
    prep = j_preprocess(js.params.xyz, scales, js.get_rotation(),
                        jnp.where(js.active[:, None], opac, 0.0), js.get_features(),
                        sh_degree=3, camera=jc, kernel_size=0.1, active_sh_degree=3)
    return prep.replace(valid=prep.valid & js.active), jc


def t_prep(prep, row0, grad=False):
    """The JAX preprocess arrays as a port PreprocessOut, xy shifted to the
    band's rows; with ``grad`` the nine blend fields are leaves."""
    def t(x):
        return torch.from_numpy(np.array(x))

    leaves = {f: t(getattr(prep, f)) for f in FIELDS}
    leaves["xy"] = leaves["xy"] - torch.tensor([0.0, float(row0)])
    if grad:
        leaves = {f: v.requires_grad_(True) for f, v in leaves.items()}
    return PreprocessOut.from_fields(t(prep.valid), t(prep.radius), t(prep.well_conditioned),
                                     **leaves), leaves


def band_kw(row0, rows):
    return dict(render_width=W, render_height=rows, band_row0=row0)


@pytest.mark.parametrize("row0,rows", [(0, 16), (16, 32), (32, 32)])
def test_band_matches_jax_band(scene, row0, rows):
    """The band's outputs and gradients against JAX's band mode: a first
    band, a middle one, and one that runs past the image's last row (50)."""
    prep, jc = scene
    shifted = prep.replace(xy=prep.xy - jnp.asarray([0.0, row0], jnp.float32))
    bg = jnp.asarray(BG, jnp.float32)

    def j_out(fvals):
        return j_rasterize(shifted.replace(**dict(zip(FIELDS, fvals))), jc, bg, backend="xla",
                           **KW, **band_kw(row0, rows))

    fvals = tuple(getattr(shifted, f) for f in FIELDS)
    jout = j_out(fvals)
    jgrads = jax.grad(lambda fv: weighted(j_out(fv), jnp))(fvals)
    tp, leaves = t_prep(prep, row0, grad=True)
    tout = t_rasterize(tp, TCamera.look_at(*CAM, device="cpu"), torch.tensor(BG), **KW,
                       **band_kw(row0, rows))
    for k in MAPS:
        assert tout[k].shape == (jout[k].shape[0], rows, W), k
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert int(tout["binning"].n_overflow) == int(jout["binning"].n_overflow) == 0
    weighted(tout, torch).backward()
    for f, jg in zip(FIELDS, jgrads):
        assert rel_err(jg, leaves[f].grad.numpy()) <= 1e-4, f


def test_bands_tile_the_full_render(scene):
    """Two bands of 32 rows (the second running past row 50) give the full
    render's rows, and the defaults render the full image."""
    prep, _ = scene
    cam = TCamera.look_at(*CAM, device="cpu")
    bg = torch.tensor(BG)
    full = t_rasterize(t_prep(prep, 0)[0], cam, bg, **KW)
    default = t_rasterize(t_prep(prep, 0)[0], cam, bg, **KW, **band_kw(0, H))
    for k in MAPS:
        assert torch.equal(full[k], default[k]), k
    bands = [t_rasterize(t_prep(prep, r0)[0], cam, bg, **KW, **band_kw(r0, 32))
             for r0 in (0, 32)]
    for k in MAPS:
        stitched = torch.cat([b[k] for b in bands], dim=1)[:, :H]
        np.testing.assert_allclose(stitched.numpy(), full[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
