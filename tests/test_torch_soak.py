"""``radegs_torch.scripts.soak_dense`` and ``decimation_sweep`` against the
JAX package's ``scripts/soak_dense.py`` and ``scripts/decimation_sweep.py``
on the CPU, each on the same seeds at a small size.

Soak: 64x48 (``bench.WIDTH`` / ``HEIGHT`` and ``synthetic.WIDTH`` /
``HEIGHT`` patched alike: the JAX script has no size arguments), 1,000
points, 4 views, 20 iterations: the report's keys equal (plus the port's
``device``), ``final_psnr`` within 0.02 dB, ``n_active_final``,
``capacity_final`` and ``final_instances`` equal.

Sweep: 400 points, 64x48, 3 views, settings ``full`` and ``auto``:
``sigma_median`` rtol 1e-6 (the two KNN scale initialisations agree to
float32 rounding), per setting the decimation voxel equal, ``verts``
within 1% (what tests/test_torch_mesh.py holds the extractors to) and
``overall`` within 5%.
"""

import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from radegs_torch.scripts import decimation_sweep as tsweep
from radegs_torch.scripts import soak_dense as tsoak
from radegs_torch.scripts import synthetic

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
W, H = 64, 48
SOAK = ["--n_points", "1000", "--n_views", "4", "--iters", "20"]
SWEEP = ["--n_points", "400", "--width", str(W), "--height", str(H), "--n_views", "3",
         "--settings", "full", "auto"]


def jax_script(name):
    """The JAX package's ``scripts/<name>.py``, imported as the scripts
    import each other (``scripts/`` on ``sys.path``)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


def read(path):
    with open(path) as f:
        return json.load(f)


def test_soak_matches_jax(tmp_path, monkeypatch):
    bench = jax_script("bench")
    jsoak = jax_script("soak_dense")
    monkeypatch.setattr(bench, "WIDTH", W)
    monkeypatch.setattr(bench, "HEIGHT", H)
    monkeypatch.setattr(synthetic, "WIDTH", W)
    monkeypatch.setattr(synthetic, "HEIGHT", H)
    monkeypatch.setattr(sys, "argv", ["soak_dense", *SOAK, "--report", str(tmp_path / "j.json")])
    jsoak.main()
    trep = tsoak.main([*SOAK, "--device", "cpu", "--report", str(tmp_path / "t.json")])
    jrep = read(tmp_path / "j.json")
    assert read(tmp_path / "t.json") == json.loads(json.dumps(trep))
    assert set(trep) == set(jrep) | {"device"}
    assert trep["device"]["type"] == "cpu" and trep["device"]["name"] is None
    for k in ("iters", "n_views", "resolution", "n_active_final", "capacity_final",
              "final_instances"):
        assert trep[k] == jrep[k], k
    assert trep["resolution"] == [W, H]
    assert np.isfinite(trep["final_psnr"])
    np.testing.assert_allclose(trep["final_psnr"], jrep["final_psnr"], atol=0.02)
    assert trep["sustained_it_per_s"] > 0
    assert trep["sustained_rays_per_s"] == trep["sustained_it_per_s"] * W * H


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep")
    jsweep = jax_script("decimation_sweep")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["decimation_sweep", *SWEEP, "--device", "cpu",
                                 "--report", str(out / "j.json")])
        jsweep.main()
    stats = {}
    trep = tsweep.main([*SWEEP, "--device", "cpu", "--report", str(out / "t.json")],
                       stats=stats)
    assert read(out / "t.json") == json.loads(json.dumps(trep))
    return read(out / "j.json"), trep, stats


def test_sweep_report_matches_jax(sweeps):
    jrep, trep, _ = sweeps
    assert trep.keys() == jrep.keys()
    for k in ("n_points", "resolution", "n_views"):
        assert trep[k] == jrep[k], k
    np.testing.assert_allclose(trep["sigma_median"], jrep["sigma_median"], rtol=1e-6)
    assert [r["setting"] for r in trep["results"]] == ["full", "auto"]


@pytest.mark.parametrize("i", [0, 1], ids=["full", "auto"])
def test_sweep_setting_matches_jax(sweeps, i):
    jrep, trep, stats = sweeps
    j, t = jrep["results"][i], trep["results"][i]
    assert t.keys() == j.keys()
    assert t["decimate_voxel"] == j["decimate_voxel"]
    assert abs(t["verts"] - j["verts"]) <= 0.01 * j["verts"]
    np.testing.assert_allclose(t["overall"], j["overall"], rtol=0.05)
    st = stats[t["setting"]]
    assert st["n_faces"] > 0 and st["n_seeds_decimated"] <= st["n_seeds"]
    assert (st["n_seeds_decimated"] < st["n_seeds"]) == (t["setting"] == "auto")
