"""Multi-rank training end to end on the CPU (gloo ranks): ``train(mesh=)``
for 3 iterations and through densification (tests/test_sharding.py:140-201,
held to the port's own single-rank loop; the densify draws are the port's
generator on every rank), ``train --multichip --world_size 2 --device
cpu`` (spawning its ranks, and under ``torchrun``), and ``bench_scaling``
and ``stress_mesh_growth`` at tiny sizes.

The densification loop is held to the active count at every iteration and
the last loss within 1e-4, and its xyz to atol 2e-3 with the rotation's
learning rate at 0 (also below 1e-5 there: 1.2e-7 seen at world 2 and 4).
At the default rate its xyz is held to a witness instead: the single-rank
loop against itself with the ground truth moved by one ulp (up, and down).
The scene's Gaussians start isotropic (equal scales), so their rotation
gradient is rounding noise, and Adam turns it into steps of about lr
sign(g) whose signs follow any change of rounding (the bands sum a
Gaussian's tiles in another order than the whole image). Once such a
Gaussian splits, its copies are placed through that rotation, so their
positions move by up to the split offset times the rotation's drift. The
one-ulp witness moves the single-rank loop's xyz by 2.12e-3 / 2.32e-3, the
ranks by 2.35e-3 at world 2 and 4: the multi-rank loop must stay within
1.5 x the witness, and the witness itself above 1e-3 (so the check is of
this sensitivity and not of a quiet scene).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.parallel import run_ranks
from radegs_torch.scripts import bench_scaling, stress_mesh_growth
from radegs_torch.scripts import train as train_cli
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
from radegs_torch.train.loop import SceneLike, train
from test_torch_parallel_ranks import rank_train
from test_torch_parallel_step import CAM, scene_arrays

torch.set_num_threads(1)
SPAWN_S = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSIFY = dict(iterations=8, regularization_from_iter=0, densify_from_iter=2,
               densification_interval=2, densify_until_iter=10, densify_grad_threshold=1e-7,
               opacity_reset_interval=1000)


@pytest.fixture(scope="module")
def ulp_witness():
    """The single-rank loop at the default rates, and the largest xyz move
    that a one-ulp change of its ground truth (up, down) gives it: (its
    state and history, the move)."""
    _, _, gt, arrays = scene_arrays()
    cfg = (dict(kernel_size=0.1), DENSIFY, dict(max_per_tile=64))
    ts_ref, hist_ref = single_rank(arrays, gt, cfg)
    xyz_ref = ts_ref.gaussians.params.xyz.numpy()
    moves = []
    for to in (2.0, -1.0):
        ts, _ = single_rank(arrays, np.nextafter(gt, np.float32(to)), cfg)
        assert int(ts.gaussians.n_active()) == int(ts_ref.gaussians.n_active())
        moves.append(float(np.abs(ts.gaussians.params.xyz.numpy() - xyz_ref).max()))
    return (ts_ref, hist_ref), max(moves)


def single_rank(arrays, gt, cfg):
    state = tgm.state_from_arrays(**arrays, device="cpu")
    return train(SceneLike(cameras=[(TCamera.look_at(*CAM, device="cpu"),
                                      torch.from_numpy(gt), 0)], extent=3.5), state,
                 ModelConfig(**cfg[0]), OptimizationConfig(**cfg[1]), PipelineConfig(**cfg[2]),
                 log_every=1, device="cpu")


def test_train_with_mesh_runs_three_iterations():
    _, _, gt, arrays = scene_arrays()
    cfg = (dict(kernel_size=0.1), dict(iterations=3, regularization_from_iter=0),
           dict(max_per_tile=64))
    ts_ref, hist_ref = single_rank(arrays, gt, cfg)
    outs = run_ranks(rank_train, 2, "gloo", "cpu", timeout_s=SPAWN_S,
                     args=(arrays, CAM, gt, [cfg]))
    (hist, fields), = outs[0].result
    assert [h["iteration"] for h in hist] == [1, 2, 3]
    for h, r in zip(hist, hist_ref):
        assert np.isfinite(h["loss"]) and abs(h["loss"] - r["loss"]) < 1e-5
        assert h["n_active"] == r["n_active"] == 48 and h["n_vis_overflow"] == 0
    np.testing.assert_allclose(fields["xyz"], ts_ref.gaussians.params.xyz.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_train_with_mesh_through_densification(world, ulp_witness):
    _, _, gt, arrays = scene_arrays()
    cfgs = [(dict(kernel_size=0.1), {**DENSIFY, **extra}, dict(max_per_tile=64))
            for extra in ({"rotation_lr": 0.0}, {})]
    outs = run_ranks(rank_train, world, "gloo", "cpu", timeout_s=SPAWN_S,
                     args=(arrays, CAM, gt, cfgs))
    (ts_def, hist_def), witness = ulp_witness
    for i, cfg in enumerate(cfgs):
        rot_frozen = cfg[1].get("rotation_lr") == 0.0
        ts_ref, hist_ref = single_rank(arrays, gt, cfg) if rot_frozen else (ts_def, hist_def)
        n_ref = int(ts_ref.gaussians.n_active())
        assert n_ref != 48, "densify / prune never changed the count"
        hist, fields = outs[0].result[i]
        assert [h["n_active"] for h in hist] == [h["n_active"] for h in hist_ref]
        assert int(fields["active"].sum()) == n_ref
        assert abs(hist[-1]["loss"] - hist_ref[-1]["loss"]) < 1e-4
        move = float(np.abs(fields["xyz"] - ts_ref.gaussians.params.xyz.numpy()).max())
        if rot_frozen:
            np.testing.assert_allclose(fields["xyz"], ts_ref.gaussians.params.xyz.numpy(),
                                       rtol=0, atol=2e-3)
            assert move < 1e-5, move
        else:
            assert witness > 1e-3, witness
            assert move <= 1.5 * witness, (move, witness)
        for o in outs[1:]:  # every rank returns the same canonical state
            assert all(np.array_equal(o.result[i][1][k], fields[k]) for k in fields)


def test_train_cli_multichip(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    common = ["--synthetic", "--iterations", "6", "--log_every", "2", "--save_iterations", "4",
              "--test_iterations", "4", "--device", "cpu", "--quiet"]
    _, hist_ref, _ = train_cli.main(common + ["-m", str(tmp_path / "one")])
    out = tmp_path / "two"
    ts, hist, _ = train_cli.main(common + ["-m", str(out), "--multichip", "--world_size", "2",
                                           "--dist_backend", "gloo"])
    assert ts.gaussians.device.type == "cpu" and int(ts.iteration) == 6
    with open(out / "history.json") as f:
        assert json.load(f) == hist
    for it in (4, 6):
        assert os.path.exists(out / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")
    assert [h["n_active"] for h in hist] == [h["n_active"] for h in hist_ref]
    for h, r in zip(hist, hist_ref):
        assert abs(h["loss"] - r["loss"]) < 1e-4, (h, r)
    with pytest.raises(ValueError, match="--ip"):
        train_cli.main(common + ["--multichip", "--ip", "127.0.0.1"])
    # under torchrun the CLI joins torchrun's group instead of spawning
    run = tmp_path / "torchrun"
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "2", "-m", "radegs_torch.scripts.train", *common,
                    "-m", str(run), "--multichip"], cwd=ROOT, check=True, timeout=SPAWN_S,
                   capture_output=True)
    with open(run / "history.json") as f:
        hist_run = json.load(f)
    assert [h["n_active"] for h in hist_run] == [h["n_active"] for h in hist]
    for h, r in zip(hist_run, hist):
        assert abs(h["loss"] - r["loss"]) < 1e-6, (h, r)


def test_bench_scaling_tiny():
    res = bench_scaling.main(["--device", "cpu", "--world_sizes", "1", "2", "--base_gaussians",
                              "200", "--width", "64", "--height", "48", "--iters", "2",
                              "--warmup", "1", "--timeout", str(SPAWN_S)])
    for n, row in res.items():
        c = row["comm"]
        assert row["timing"] == "cpu" and "weak_scaling_efficiency" not in row
        assert row["backend"] == "gloo" and row["complete"]  # budget sized from the view
        assert row["n_overflow"] == row["tile_overflow"] == 0
        assert len(row["ms_per_iter_per_rank"]) == n and np.isfinite(row["loss"])
        assert c["gather_rows"] == c["full_gather_rows"] == 4096 and c["n_vis_overflow"] == 0
        assert 0 < c["n_vis"] <= 200 * n


def test_stress_mesh_growth_tiny(tmp_path):
    rep = stress_mesh_growth.main(["--device", "cpu", "--n0", "300", "--width", "32", "--iters",
                                   "7", "--target", "600", "--mpt", "256", "--timeout",
                                   str(SPAWN_S), "--report", str(tmp_path / "r.json")])
    assert rep["failed"] == [] and rep["n_active_sharded"] >= 600
    assert rep["parity_count_delta"] == 0 and rep["parity_max_dxyz"] < 2e-3
