"""The port's small leftovers against the JAX package on the same numpy
inputs (JAX on the CPU): ``gaussian_model.update_3d_filter_partial`` on
tests/test_model.py's case (rtol 1e-6: new rows recomputed, old rows kept,
inactive rows 0), ``utils/vis.normal_to_rgb`` (equal) and
``utils/vis.save_points_ply`` (the same bytes as the JAX writer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.models import gaussian_model as jgm
from radegs_tpu.utils import vis as jvis
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.utils import vis as tvis

torch.set_num_threads(1)
CAM = ([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 64, 64)


def carried(js):
    p = js.params
    return tgm.state_from_arrays(
        *(np.asarray(getattr(p, k)) for k in
          ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")),
        np.asarray(js.active), np.asarray(js.filter_3d), int(js.active_sh_degree),
        js.max_sh_degree, device="cpu")


@pytest.mark.parametrize("every", [3, 1, 2])
def test_update_3d_filter_partial_matches_jax(every):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    jcam = JCamera.look_at(*CAM)
    tcam = TCamera.look_at(*CAM, device="cpu")
    js = jgm.update_3d_filter(jgm.create_from_points(pts, cols, sh_degree=0), [jcam])
    stale = js.replace(filter_3d=js.filter_3d + 0.123)
    new_mask = np.arange(js.capacity) % every == 0
    jpart = jgm.update_3d_filter_partial(stale, [jcam], jnp.asarray(new_mask))
    tpart = tgm.update_3d_filter_partial(carried(stale), [tcam], torch.from_numpy(new_mask))
    got, want = tpart.filter_3d.numpy(), np.asarray(jpart.filter_3d)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    act = np.asarray(js.active)
    full = tgm.update_3d_filter(carried(js), [tcam]).filter_3d.numpy()
    np.testing.assert_allclose(got[act & new_mask], full[act & new_mask], rtol=1e-6)
    np.testing.assert_array_equal(got[act & ~new_mask],
                                  np.asarray(stale.filter_3d)[act & ~new_mask])
    assert (got[~act] == 0).all() and (~act).any()


def test_normal_to_rgb_matches_jax():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(3, 12, 17)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, 0, 0] = [2.0, -3.0, 0.0]  # clipped both ways
    got = tvis.normal_to_rgb(n)
    np.testing.assert_array_equal(got, jvis.normal_to_rgb(n))
    assert got.shape == (12, 17, 3) and got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize("colors", ["none", "float", "uint8"])
def test_save_points_ply_same_bytes(tmp_path, colors):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(257, 3))
    cols = {"none": None, "float": rng.uniform(-0.1, 1.1, (257, 3)),
            "uint8": rng.integers(0, 256, (257, 3)).astype(np.uint8)}[colors]
    tvis.save_points_ply(tmp_path / "t.ply", pts, cols)
    jvis.save_points_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
