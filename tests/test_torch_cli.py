"""The port's command-line layer against the JAX package's: argument parsing
(``train/arguments.py``), ``cfg_args`` both ways, ``get_combined_args``,
checkpoints (``utils/checkpoint.py``, capacities as
``radegs_tpu/utils/checkpoint.py`` restores them), and the four CLIs end to
end on the CPU at 48x48: synthetic training with save, checkpoint and
resume, then training, rendering and both mesh extractors on a small COLMAP
dataset written here.
"""

import argparse
import dataclasses
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.train import arguments as jargs
from radegs_tpu.train import config as jconfig
from radegs_tpu.utils.trajectories import ellipse_path as j_ellipse_path
from radegs_torch.core.camera import Camera as TCamera
from radegs_torch.core.camera import fov2focal
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.scripts import mesh_extract, mesh_extract_tetrahedra, render
from radegs_torch.scripts import train as train_cli
from radegs_torch.train import arguments as targs
from radegs_torch.train import config as tconfig
from radegs_torch.train.loop import init_train_state
from radegs_torch.utils import checkpoint as ckpt
from radegs_torch.utils.image import read_png, write_png
from radegs_torch.utils.ply import read_mesh
from radegs_torch.utils.trajectories import ellipse_path

torch.set_num_threads(2)
GROUPS = ("ModelConfig", "OptimizationConfig", "PipelineConfig")
# where the two packages' configurations differ on purpose: the default
# device, the JAX-only backend knob, the port's blend blocking
JAX_ONLY = {"backend"}
PORT_ONLY = {"tiles_per_block"}
DEFAULTS_DIFFER = {"data_device": ("tpu", "cuda")}


def parser(mod, cfg):
    p = argparse.ArgumentParser()
    for g in GROUPS:
        mod.add_group(p, getattr(cfg, g), g)
    return p


def test_parser_parity():
    jp, tp = parser(jargs, jconfig), parser(targs, tconfig)
    jd = {a.dest: (a.default, a.option_strings, type(a).__name__) for a in jp._actions}
    td = {a.dest: (a.default, a.option_strings, type(a).__name__) for a in tp._actions}
    assert set(jd) - set(td) == JAX_ONLY and set(td) - set(jd) == PORT_ONLY
    for k in set(jd) & set(td):
        if k in DEFAULTS_DIFFER:
            assert (jd[k][0], td[k][0]) == DEFAULTS_DIFFER[k]
            continue
        assert jd[k] == td[k], k
    argv = ["-s", "data", "-m", "out", "-r", "2", "-w", "--iterations", "77",
            "--lambda_dssim", "0.3", "--use_decoupled_appearance", "--max_per_tile", "1024"]
    ja, ta = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
    assert {k: v for k, v in ja.items() if k in ta and k not in DEFAULTS_DIFFER} == \
        {k: v for k, v in ta.items() if k in ja and k not in DEFAULTS_DIFFER}
    cfg = targs.extract(tconfig.OptimizationConfig, tp.parse_args(argv))
    assert cfg.iterations == 77 and cfg.lambda_dssim == 0.3


def test_cfg_args_both_ways(tmp_path):
    jm = jconfig.ModelConfig(source_path="/d/s", model_path=str(tmp_path / "j"), resolution=2,
                             kernel_size=0.1, use_decoupled_appearance=True)
    tm = tconfig.ModelConfig(source_path="/d/s", model_path=str(tmp_path / "t"), resolution=2,
                             kernel_size=0.1, use_decoupled_appearance=True)
    jargs.save_cfg_args(jm.model_path, jm)
    targs.save_cfg_args(tm.model_path, tm)
    for path, cfg in ((jm.model_path, jm), (tm.model_path, tm)):
        want = dataclasses.asdict(cfg)
        assert jargs.load_cfg_args(path) == targs.load_cfg_args(path) == want
    assert targs.load_cfg_args(jm.model_path)["data_device"] == "tpu"


def test_get_combined_args_merges_the_same_way(tmp_path):
    m = str(tmp_path / "m")
    targs.save_cfg_args(m, tconfig.ModelConfig(source_path="/data/x", model_path=m,
                                               kernel_size=0.1, white_background=True,
                                               resolution=4))
    argv = ["-m", m, "--resolution", "2", "--iteration", "5"]
    out = []
    for mod, cfg in ((jargs, jconfig), (targs, tconfig)):
        p = argparse.ArgumentParser()
        mod.add_group(p, cfg.ModelConfig, "ModelParams")
        p.add_argument("--iteration", type=int, default=-1)
        out.append(vars(mod.get_combined_args(p, argv)))
    shared = set(out[0]) & set(out[1]) - set(DEFAULTS_DIFFER)
    assert {k: out[0][k] for k in shared} == {k: out[1][k] for k in shared}
    t = out[1]
    assert (t["source_path"], t["kernel_size"], t["white_background"]) == ("/data/x", 0.1, True)
    assert t["resolution"] == 2 and t["iteration"] == 5  # explicit values win


def small_state(capacity=64, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return tgm.create_from_points(rng.normal(size=(n, 3)).astype(np.float32),
                                  rng.uniform(size=(n, 3)).astype(np.float32),
                                  capacity=capacity, device="cpu")


def assert_states_equal(a, b, n):
    for k, v in a.gaussians.params.items():
        assert torch.equal(getattr(b.gaussians.params, k)[:n], v[:n]), k
        assert torch.equal(getattr(b.gaussians.adam_m, k)[:n], getattr(a.gaussians.adam_m, k)[:n])
        assert torch.equal(getattr(b.gaussians.adam_v, k)[:n], getattr(a.gaussians.adam_v, k)[:n])
    for k in tgm.TRAINING_FIELDS + ("active", "filter_3d"):
        assert torch.equal(getattr(b.gaussians, k)[:n], getattr(a.gaussians, k)[:n]), k
    assert b.gaussians.adam_step == a.gaussians.adam_step


@pytest.mark.parametrize("appearance", [False, True])
def test_checkpoint_capacities(tmp_path, appearance):
    """radegs_tpu/utils/checkpoint.py:77: capacity max(checkpoint, template,
    capacity); tests/test_checkpoint.py's cases for the port."""
    gen = torch.Generator().manual_seed(0)
    g = small_state()
    rng = np.random.default_rng(1)
    g = g.replace(adam_m=g.params.map(lambda x: torch.from_numpy(
        rng.normal(size=x.shape).astype(np.float32))), adam_step=7,
        grad_accum=torch.from_numpy(rng.uniform(size=64).astype(np.float32)))
    grown = tgm.resize_capacity(g, 256)  # grown mid-run: 64 -> 256
    ts = init_train_state(grown, appearance, 48, 48, gen).replace(iteration=777)
    path = str(tmp_path / "chkpnt777")
    ckpt.save_checkpoint(path, ts, 777)
    assert ckpt.checkpoint_capacity(path) == 256
    template = init_train_state(g, appearance, 48, 48, torch.Generator().manual_seed(5))
    restored, it = ckpt.load_checkpoint(path, template)  # a smaller template
    assert it == 777 and restored.iteration == 777 and restored.gaussians.capacity == 256
    assert_states_equal(ts, restored, 256)
    if appearance:
        for n in ("app_params", "app_m", "app_v"):
            for k, v in getattr(ts, n)["net"].items():
                assert torch.equal(getattr(restored, n)["net"][k], v)
            assert torch.equal(getattr(restored, n)["embeddings"], getattr(ts, n)["embeddings"])
    # a small checkpoint into a larger template keeps the headroom
    small = init_train_state(g, appearance, 48, 48, gen)
    ckpt.save_checkpoint(str(tmp_path / "small"), small, 5)
    big = init_train_state(tgm.resize_capacity(g, 512), appearance, 48, 48, gen)
    r2, it2 = ckpt.load_checkpoint(str(tmp_path / "small"), big)
    assert it2 == 5 and r2.gaussians.capacity == 512 and not r2.gaussians.active[64:].any()
    assert_states_equal(small, r2, 64)
    r3, _ = ckpt.load_checkpoint(str(tmp_path / "small"), small, capacity=128)
    assert r3.gaussians.capacity == 128
    with pytest.raises(ValueError, match="appearance"):
        ckpt.load_checkpoint(path, init_train_state(g, not appearance, 48, 48, gen))


def test_checkpoint_refuses_other_files(tmp_path):
    torch.save({"state": 1}, tmp_path / "x")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_checkpoint(str(tmp_path / "x"), init_train_state(small_state()))


@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_unported_flags_raise(tmp_path, no_tensorboard):
    """--multichip is ported (tests/test_torch_parallel_train.py); what it
    refuses raises before any rank starts: the viewer, which serves from one
    rank, and NCCL with more ranks than cards."""
    common = ["--synthetic", "-m", str(tmp_path), "--device", "cpu", "--multichip"]
    with pytest.raises(ValueError, match="--ip"):
        train_cli.main([*common, "--ip", "127.0.0.1"])
    with pytest.raises(ValueError, match="gloo"):
        train_cli.main([*common, "--world_size", "2", "--dist_backend", "nccl"])


def test_train_cli_synthetic_save_checkpoint_resume(tmp_path, no_tensorboard):
    m1, m2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    common = ["--synthetic", "--device", "cpu", "--kernel_size", "0.1", "--log_every", "5",
              "--quiet"]
    ts, hist, _ = train_cli.main([*common, "-m", m1, "--iterations", "30", "--save_iterations",
                                  "15", "--checkpoint_iterations", "15"])
    assert ts.iteration == 30 and [h["iteration"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["psnr"] > hist[0]["psnr"]
    for rel in ("cfg_args", "history.json", "chkpnt15", "point_cloud/iteration_15/point_cloud.ply",
                "point_cloud/iteration_30/point_cloud.ply"):
        assert os.path.exists(os.path.join(m1, rel)), rel
    with open(os.path.join(m1, "history.json")) as f:
        assert json.load(f) == hist
    ts2, hist2, _ = train_cli.main([*common, "-m", m2, "--iterations", "30",
                                    "--start_checkpoint", os.path.join(m1, "chkpnt15")])
    assert ts2.iteration == 30 and [h["iteration"] for h in hist2] == [20, 25, 30]


def write_colmap_dataset(root, cams):
    """A COLMAP model of the synthetic views: one PINHOLE camera, the views'
    renders as PNGs, 60 seeded points with two-entry tracks."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cam0 = cams[0][0]
    W, H = cam0.width, cam0.height
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ4d", 1, 1, 1, W, H, fov2focal(float(cam0.fovx), W),
                            fov2focal(float(cam0.fovy), H), W / 2, H / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, (cam, gt, _) in enumerate(cams):
            from scipy.spatial.transform import Rotation

            x, y, z, w = Rotation.from_matrix(cam.R.numpy().astype(np.float64).T).as_quat()
            name = f"v{i:02d}.png"
            f.write(struct.pack("<i4d3di", i + 1, w, x, y, z, *cam.T.numpy().astype(np.float64),
                                1) + name.encode() + b"\x00" + struct.pack("<Q", 0))
            write_png(os.path.join(root, "images", name),
                      (gt.permute(1, 2, 0).numpy() * 255 + 0.5).astype(np.uint8))
    rng = np.random.default_rng(3)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 60))
        for i in range(60):
            f.write(struct.pack("<Q3d3BdQ4i", i, *(rng.normal(size=3) * 0.5),
                                *rng.integers(0, 256, 3).tolist(), 0.5, 2, 1, i, 2, i))


def test_clis_on_a_colmap_dataset(tmp_path, no_tensorboard):
    cams, _ = train_cli.synthetic_scene(size=48, n_cams=9, device="cpu")
    ds, m = str(tmp_path / "ds"), str(tmp_path / "m")
    write_colmap_dataset(ds, cams)
    _, hist, tpsnr = train_cli.main([
        "-s", ds, "-m", m, "--eval", "--device", "cpu", "--iterations", "40", "--kernel_size",
        "0.1", "--test_iterations", "1", "40", "--save_iterations", "40", "--log_every", "10",
        "--quiet", "--densify_from_iter", "10", "--densification_interval", "20",
        "--position_lr_init", "0.005"])
    assert sorted(tpsnr) == [1, 40] and tpsnr[40] > tpsnr[1]
    for rel in ("cameras.json", "input.ply", "cfg_args", "point_cloud/iteration_40/point_cloud.ply"):
        assert os.path.exists(os.path.join(m, rel)), rel
    render.main(["-m", m, "--device", "cpu", "--save_depth", "--path_frames", "2"])
    shapes = {}
    for sub in ("train/ours_40/renders", "train/ours_40/gt", "test/ours_40/renders",
                "video_40"):
        for name in sorted(os.listdir(os.path.join(m, sub))):
            shapes[f"{sub}/{name}"] = read_png(os.path.join(m, sub, name)).shape
    assert shapes["test/ours_40/renders/00001.png"] == (48, 48, 3)
    assert shapes["test/ours_40/renders/00001_depth.png"] == (48, 48)
    assert shapes["video_40/00001_depth.png"] == (48, 48, 3)
    assert len([k for k in shapes if k.startswith("train/ours_40/gt")]) == 7  # 9 - every 8th
    verts, faces = mesh_extract.main(["-m", m, "--device", "cpu", "--voxel_size", "0.02",
                                      "--max_resolution", "48", "--cluster_to_keep", "5"])
    assert len(faces) > 100 and os.path.exists(os.path.join(m, "recon_post.ply"))
    assert read_mesh(os.path.join(m, "recon.ply"))[1].shape == faces.shape
    tv, tf = mesh_extract_tetrahedra.main(["-m", m, "--device", "cpu", "--binary_steps", "2"])
    assert len(tf) > 100 and read_mesh(os.path.join(m, "recon.ply"))[1].shape == tf.shape


def test_ellipse_path_matches_jax():
    """The render CLI's --path_frames orbit: the same cameras (rtol 1e-5)."""
    rng = np.random.default_rng(2)
    ring = []
    for i in range(7):
        a = 2 * np.pi * i / 7
        eye = [3.0 * np.sin(a), 0.4 + 0.1 * rng.normal(), -2.5 * np.cos(a)]
        ring.append((eye, [0.1, 0, 0.2], [0, 1, 0], 0.8, 0.6, 40, 30))
    jp = j_ellipse_path([JCamera.look_at(*r) for r in ring], n_frames=5, z_variation=0.3)
    tp = ellipse_path([TCamera.look_at(*r, device="cpu") for r in ring], n_frames=5,
                      z_variation=0.3)
    assert len(tp) == len(jp) == 5
    for j, t in zip(jp, tp):
        assert (t.width, t.height) == (j.width, j.height)
        np.testing.assert_allclose(t.world_view.numpy(), np.asarray(j.world_view), rtol=1e-5,
                                   atol=1e-5)


def small_render_scene():
    cams, _ = train_cli.synthetic_scene(size=48, n_cams=1, device="cpu")
    rng = np.random.default_rng(4)
    state = tgm.create_from_points((rng.normal(size=(60, 3)) * 0.5).astype(np.float32),
                                   rng.uniform(size=(60, 3)).astype(np.float32), capacity=64,
                                   device="cpu")
    return state, cams[0][0]


def test_render_complete_sizes_the_work_buffers_from_the_demand():
    """The CLIs' renders drop nothing: ``render`` without an instance budget
    grows a starved max_per_tile to the measured per-tile demand, and the
    result equals an unstarved render; with a budget it drops as told."""
    from radegs_torch.renderer import render

    state, cam = small_render_scene()
    with torch.no_grad():
        starved = render(state, cam, [0, 0, 0], max_per_tile=2, instance_budget=1 << 14,
                         device="cpu")
        full = render(state, cam, [0, 0, 0], max_per_tile=4096, device="cpu")
        done = render(state, cam, [0, 0, 0], max_per_tile=2, device="cpu")
    assert int(starved["binning"].tile_overflow) > 0
    assert int(done["binning"].tile_overflow) == 0 == int(done["binning"].n_overflow)
    assert torch.equal(done["render"], full["render"])


def test_render_grows_a_default_budget_that_drops_instances(monkeypatch):
    """A default budget below the view's demand is grown to it (budget and
    per-tile cut at once), and the render equals an unstarved one."""
    from radegs_torch import renderer

    state, cam = small_render_scene()
    with torch.no_grad():
        full = renderer.render(state, cam, [0, 0, 0], max_per_tile=4096, device="cpu")
        monkeypatch.setattr(renderer, "default_instance_budget", lambda capacity: 8)
        done = renderer.render(state, cam, [0, 0, 0], max_per_tile=2, device="cpu")
    assert int(full["binning"].n_instances) > 8
    assert int(done["binning"].tile_overflow) == 0 == int(done["binning"].n_overflow)
    assert torch.equal(done["render"], full["render"])


def test_render_warns_when_it_still_drops_at_the_cap(monkeypatch):
    from radegs_torch import renderer

    state, cam = small_render_scene()
    monkeypatch.setattr(renderer, "MAX_PER_TILE_CAP", 2)
    with torch.no_grad(), pytest.warns(UserWarning, match="render dropped 0 instances"):
        out = renderer.render(state, cam, [0, 0, 0], max_per_tile=2, device="cpu")
    assert int(out["binning"].tile_overflow) > 0
