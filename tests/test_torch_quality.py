"""``radegs_torch.scripts.quality_dense`` (and its scene, ``synthetic``)
against the JAX package's ``scripts/quality_dense.py`` on the CPU.

The scene and the scoring are numpy: ``surface_points``,
``analytic_distance`` and ``sample_analytic_surface`` equal the JAX
script's bitwise, ``mesh_chamfer`` within 1e-12 on the same mesh, the orbit
cameras within 1e-6. Both ``main``s run the protocol at 64x48 with 2,000
points, 8 views (6 train / 2 test) and 20 iterations (no densification at
that length): the ground-truth renders within atol 5e-5 (the render
tolerance of test_torch_render.py), the report's keys equal less the XLA
compile counts and plus ``device``, ``n_active`` and ``health`` equal, and
every eval's per-view test and train PSNR within 0.02 dB (2e-5 dB apart on
this run: the two trainings agree step by step to float32 rounding).

The port's wall budget, checkpoint resume and recovery mode, and its mesh
branch (both extractors on the recovered state, with finite scores), run at
500 points: the plain integrate walk of the tetra SDF passes on the CPU
costs minutes at 2,000. The TSDF grid is held at ``max_resolution`` 128
there (the protocol's 0.004 voxel clamps at 768, ~60 s of host meshing on
the CPU). The JAX mesh branch is not run: it does not fit this file's time,
and ``tests/test_torch_soak.py`` holds the tetra extractor and
``mesh_chamfer`` to the JAX sweep's.
"""

import functools
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from radegs_torch.scripts import quality_dense as tq
from radegs_torch.scripts import soak_dense as tsoak
from radegs_torch.scripts import synthetic
from radegs_torch.train import loop as _  # noqa: F401  bound to render before the fixture patches it

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
SMALL = ["--n_points", "2000", "--width", "64", "--height", "48", "--n_views", "8",
         "--eval_every", "4", "--iters", "20", "--eval_iters", "1", "10", "20", "--skip_mesh",
         "--device", "cpu"]
XLA_KEYS = {"xla_compiles", "xla_compile_wall_s", "xla_compiles_by_name"}
PSNR_TOL = 0.02  # dB
RENDER_ATOL = 5e-5


def jax_script(name):
    """The JAX package's ``scripts/<name>.py``, imported as the scripts
    import each other (``scripts/`` on ``sys.path``)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


def test_surface_points_bitwise():
    bench = jax_script("bench")
    for noise in (1.0, 0.0):
        for n in (3000, 2001):
            want = bench._surface_points(n, np.random.default_rng(5), noise=noise)
            got = synthetic.surface_points(n, np.random.default_rng(5), noise=noise)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (synthetic.WIDTH, synthetic.HEIGHT) == (bench.WIDTH, bench.HEIGHT)


def test_orbit_cameras_match():
    jsoak = jax_script("soak_dense")
    for n, w, h in ((12, 1600, 1200), (8, 64, 48)):
        jc, tc = jsoak.orbit_cameras(n, w, h), tsoak.orbit_cameras(n, w, h, device="cpu")
        for a, b in zip(jc, tc):
            assert (a.width, a.height) == (b.width, b.height)
            for name in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_allclose(getattr(b, name).numpy(),
                                           np.asarray(getattr(a, name)), atol=1e-6)


def test_analytic_scoring_bitwise():
    jq = jax_script("quality_dense")
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.normal(size=(4000, 3)) * 2.0,
                        synthetic.surface_points(2000, rng, noise=0.5)]).astype(np.float32)
    assert tq.analytic_distance(p).tobytes() == jq.analytic_distance(p).tobytes()
    a = tq.sample_analytic_surface(20_000, np.random.default_rng(7))
    b = jq.sample_analytic_surface(20_000, np.random.default_rng(7))
    assert a.tobytes() == b.tobytes()


def test_mesh_chamfer_matches_jax():
    from scipy.spatial import ConvexHull

    jq = jax_script("quality_dense")
    rng = np.random.default_rng(4)
    d = rng.normal(size=(600, 3))
    verts = (d / np.linalg.norm(d, axis=1, keepdims=True)
             * (1.3 + 0.03 * rng.normal(size=(600, 1)))).astype(np.float32)
    faces = ConvexHull(verts).simplices
    got = tq.mesh_chamfer(verts, faces, np.random.default_rng(7))
    want = jq.mesh_chamfer(verts, faces, np.random.default_rng(7))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Both mains on the small protocol, each render they make recorded
    (the first 8: the ground truth)."""
    import radegs_torch.renderer as trenderer

    import radegs_tpu.renderer as jrenderer

    out = tmp_path_factory.mktemp("quality")
    jrenders, trenders = [], []
    jrender, trender = jrenderer.render_compiled, trenderer.render

    def jrec(*a, **k):
        res = jrender(*a, **k)
        jrenders.append(np.asarray(res["render"]))
        return res

    def trec(*a, **k):
        res = trender(*a, **k)
        trenders.append(res["render"].numpy().copy())
        return res

    jq = jax_script("quality_dense")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_compiled", jrec)
        mp.setattr(trenderer, "render", trec)
        mp.setattr(sys, "argv", ["quality_dense", *SMALL, "--report", str(out / "j.json")])
        jq.main()
        trep = tq.main([*SMALL, "--report", str(out / "t.json")])
    with open(out / "j.json") as f:
        jrep = json.load(f)
    with open(out / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(trep))
    return jrep, trep, jrenders, trenders


def test_ground_truth_renders_match(both_runs):
    _, _, jr, tr = both_runs
    assert len(jr) == len(tr) == 8 + 3 * 4  # 8 GT views, 3 evals of 2 test + 2 train
    for a, b in zip(jr[:8], tr[:8]):
        np.testing.assert_allclose(np.clip(b, 0, 1), np.clip(a, 0, 1), atol=RENDER_ATOL)


def test_report_fields_match(both_runs):
    jrep, trep, _, _ = both_runs
    assert set(trep) == (set(jrep) - XLA_KEYS) | {"device"}
    assert trep["device"] == {"type": "cpu", "name": None, "nvidia_smi": None,
                              "max_memory_allocated": None}
    for k in ("iters", "iters_completed", "partial", "train_views", "test_views",
              "resolution", "recovered_from_checkpoint", "n_active_final", "capacity_final",
              "health"):
        assert trep[k] == jrep[k], k
    assert trep["health"] == {"overflow_events": 0, "overflow_instances": 0.0, "nan_events": 0}
    assert trep["sustained_it_per_s"] > 0 and trep["train_wall_s"] > 0


def test_eval_psnr_matches(both_runs):
    jrep, trep, _, _ = both_runs
    assert [e["iter"] for e in trep["eval"]] == [e["iter"] for e in jrep["eval"]] == [1, 10, 20]
    for je, te in zip(jrep["eval"], trep["eval"]):
        assert te["n_active"] == je["n_active"]
        np.testing.assert_allclose(te["psnr_per_view"], je["psnr_per_view"], atol=PSNR_TOL)
        np.testing.assert_allclose(te["psnr_train"], je["psnr_train"], atol=PSNR_TOL)
        np.testing.assert_allclose(te["psnr_test"], je["psnr_test"], atol=PSNR_TOL)
    # the protocol trains: test PSNR climbs over the 20 iterations
    assert trep["eval"][-1]["psnr_test"] > trep["eval"][0]["psnr_test"] + 1.0


def test_wall_budget_resume_and_recovery(tmp_path, monkeypatch):
    """--wall_budget 0 stops after iteration 1 with partial true and a
    checkpoint (no log point reached: the rate fields null); a second run
    resumes there and completes; a third finds the checkpoint at --iters,
    trains zero iterations, evaluates the same state again, leaves the rate
    fields null and scores both meshes."""
    from radegs_torch.mesh import tsdf

    ck = str(tmp_path / "q.pt")
    args = ["--n_points", "500", "--width", "64", "--height", "48", "--n_views", "8",
            "--iters", "3", "--eval_iters", "3", "--device", "cpu", "--checkpoint", ck]
    cut = tq.main([*args, "--skip_mesh", "--wall_budget", "0",
                   "--report", str(tmp_path / "cut.json")])
    assert cut["partial"] and cut["iters_completed"] == 1
    assert [e["iter"] for e in cut["eval"]] == [1]
    # no log point was reached, so no rate was measured
    assert cut["sustained_it_per_s"] is None and cut["train_wall_s"] is None

    resumed = tq.main([*args, "--skip_mesh", "--report", str(tmp_path / "resumed.json")])
    assert not resumed["partial"] and resumed["iters_completed"] == 3
    assert not resumed["recovered_from_checkpoint"]
    assert [e["iter"] for e in resumed["eval"]] == [3]

    monkeypatch.setattr(tsdf, "extract_mesh_tsdf",
                        functools.partial(tsdf.extract_mesh_tsdf, max_resolution=128))
    recovered = tq.main([*args, "--report", str(tmp_path / "recovered.json")])
    assert recovered["recovered_from_checkpoint"] and not recovered["partial"]
    assert recovered["train_wall_s"] is None and recovered["sustained_it_per_s"] is None
    assert recovered["it_per_s_by_1k"] == {}
    # the same state, with its 3D filter refreshed from the moved centres as
    # every train() call starts
    (re,), (rr,) = resumed["eval"], recovered["eval"]
    assert rr["iter"] == re["iter"] and rr["n_active"] == re["n_active"]
    np.testing.assert_allclose(rr["psnr_per_view"], re["psnr_per_view"], atol=1e-3)
    assert recovered["capacity_final"] == resumed["capacity_final"]
    for name in ("tsdf", "tetra"):
        m = recovered[name]
        assert m["verts"] > 0 and m["faces"] > 0, name
        assert all(np.isfinite(m[k]) for k in ("accuracy_mean", "completeness_mean",
                                               "overall")), name
        assert (tmp_path / f"recovered_{name}.ply").exists()
    assert recovered["tsdf"]["stats"]["voxel_size"] > 0.004  # clamped at 128
    assert recovered["tetra"]["stats"]["n_faces"] == recovered["tetra"]["faces"]
