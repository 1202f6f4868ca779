"""``radegs_torch.scripts.bench`` and ``bench_breakdown`` against the JAX
package's ``bench.py`` on the CPU, both modules' sizes shrunk alike
(``SHRUNK``: 2,000 / 3,000 points at 160x120).

(a) ``build_scene``, both scenes: every parameter and the 3D filter at the
create_from_points tolerance of tests/test_torch_train.py (rtol 1e-5, atol
1e-6), ``active``, the ground truth and the camera. (b) One bench step a
scene from the JAX scene carried into the port, with the bench's configs:
the loss within rel 1e-5, ``n_instances`` / ``n_overflow`` /
``tile_overflow`` equal, the parameters after Adam at the one-step
tolerance of test_torch_train.py (rtol 1e-4, atol 1e-7 where the gradient
is clearly away from zero). (c) The ``--auto`` settle from a starved
configuration: the same (max_per_tile, instance_budget) sequence as the
loop of bench.py:257-271 run around the JAX ``autotune_pipeline``. (d) The
parity check's inputs (preprocess rtol 1e-4 / atol 1e-5, binning lists
exact), its error formula on a hand example, and its refusal on the CPU.
(e) ``main`` with ``--scene both``: the last line's keys are the JAX
bench's (its merged line, the children run in this process) without
``xla_compiles``, with ``stages_ms`` / ``stages_ms_dense``. (f) The
breakdown's key mapping. (g) On a card only: the parity check within 1e-4
and every stage mark in a real step.
"""

import argparse
import contextlib
import io
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radegs_tpu.core.camera import Camera as JCamera
from radegs_tpu.core.projection import preprocess_gaussians as j_preprocess
from radegs_tpu.ops.binning import bin_gaussians as j_bin
from radegs_tpu.train import loop as jloop
from radegs_tpu.train.config import ModelConfig as JModelConfig
from radegs_tpu.train.config import OptimizationConfig as JOptimizationConfig
from radegs_tpu.train.config import PipelineConfig as JPipelineConfig
from radegs_torch.models import gaussian_model as tgm
from radegs_torch.scripts import bench as tbench
from radegs_torch.scripts import bench_breakdown as tbreak
from radegs_torch.train import loop as tloop
from radegs_torch.train.config import PipelineConfig

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import bench as jbench  # noqa: E402  the JAX package's headline bench

PARAMS = ["xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"]
SHRUNK = dict(N_GAUSS=2000, CAPACITY=4096, DENSE_N=3000, DENSE_CAPACITY=4096, WIDTH=160,
              HEIGHT=120, WARMUP=1, ITERS=1)
SCENES = ("100k", "dense")
STARVED = dict(max_per_tile=128, instance_budget=1 << 13)  # the dense view needs 475 / 16,226
# a real step's marks in order (bench_breakdown.STAGE_OF), as the card records them
STEP_MARKS = ["start", "start", "preprocess", "binning", "pack_features", "blend", "normalize",
              "render", "loss", "tail_backward", "bwd_features", "pack_aux",
              "instance_segments", "bwd_walk", "bwd_segment_sum", "backward", "adam", "stats"]
JAX_KEYS = ["preprocess", "binning", "pack_align", "blend_fwd", "loss_tail", "backward",
            "adam_stats", "full", "bwd_kernel_only", "bwd_reduction"]


@pytest.fixture(scope="module", autouse=True)
def shrunk():
    """Both benches shrunk alike, and the JAX ``make_train_step`` (also as
    ``inner_main`` imports it) cached by configuration: both scenes have
    capacity 4096, so a configuration's step compiles once for both."""
    mp = pytest.MonkeyPatch()
    for k, v in SHRUNK.items():
        mp.setattr(jbench, k, v)
        mp.setattr(tbench, k, v)
    steps, make = {}, jloop.make_train_step

    def cached(mcfg, ocfg, pcfg, spatial_lr_scale):
        key = (mcfg, ocfg, pcfg, spatial_lr_scale)
        if key not in steps:
            steps[key] = make(mcfg, ocfg, pcfg, spatial_lr_scale=spatial_lr_scale)
        return steps[key]

    mp.setattr(jloop, "make_train_step", cached)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scenes(shrunk):
    """Each scene built by both packages: {scene: (JAX (state, cam, gt),
    port (state, cam, gt))}."""
    return {s: (jbench.build_scene(scene=s), tbench.build_scene(scene=s, device="cpu"))
            for s in SCENES}


def close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(b.detach() if torch.is_tensor(b) else b),
                               np.asarray(a), rtol=rtol, atol=atol, err_msg=msg)


def carry(js):
    """A JAX GaussianState, training fields included, into a port state."""
    p = js.params
    tr = {k: np.asarray(getattr(js, k)) for k in tgm.TRAINING_FIELDS}
    tr["adam_m"] = {k: np.asarray(getattr(js.adam_m, k)) for k in PARAMS}
    tr["adam_v"] = {k: np.asarray(getattr(js.adam_v, k)) for k in PARAMS}
    tr["adam_step"] = int(js.adam_step)
    return tgm.state_from_arrays(
        *(np.asarray(getattr(p, k)) for k in PARAMS), np.asarray(js.active),
        np.asarray(js.filter_3d), int(js.active_sh_degree), js.max_sh_degree,
        device="cpu", training=tr)


def jax_configs(scene, pcfg=None):
    """The JAX bench's configs (bench.py:232-250, not --auto)."""
    if pcfg is None:
        pcfg = (JPipelineConfig(max_per_tile=512) if scene == "100k" else
                JPipelineConfig(max_per_tile=8192, instance_multiplier=8))
    return JModelConfig(kernel_size=0.1), JOptimizationConfig(regularization_from_iter=0), pcfg


def jax_step(js, jcam, jgt, cfgs):
    """bench.py's first step from a fresh train state (a copy: the step
    donates it) with ``cfgs`` (model, optimisation, pipeline); returns
    (ts, metrics)."""
    jts = jloop.init_train_state(jax.tree.map(jnp.array, js), jax.random.PRNGKey(0))
    step = jloop.make_train_step(*cfgs, spatial_lr_scale=5.0)
    return step(jts, jcam, jgt, jnp.zeros(3), 0, tbench.WIDTH, tbench.HEIGHT)


# ------------------------------------------------------------ (a) scenes ----


@pytest.mark.parametrize("scene", SCENES)
def test_build_scene_matches_jax(scenes, scene):
    (js, jcam, jgt), (ts, tcam, tgt) = scenes[scene]
    assert ts.capacity == js.capacity == 4096
    for k in PARAMS:
        close(getattr(js.params, k), getattr(ts.params, k), 1e-5, 1e-6, msg=k)
    assert (np.asarray(js.active) == ts.active.numpy()).all()
    assert int(ts.active.sum()) == (3000 if scene == "dense" else 2000)
    close(js.filter_3d, ts.filter_3d, 1e-5, 1e-6, msg="filter_3d")
    assert (ts.active_sh_degree, ts.max_sh_degree) == (int(js.active_sh_degree),
                                                       js.max_sh_degree)
    assert tgt.shape == (3, 120, 160) and (np.asarray(jgt) == tgt.numpy()).all()
    for k in ("R", "T", "fovx", "fovy"):
        close(getattr(jcam, k), getattr(tcam, k), 1e-6, 1e-7, msg=k)
    assert (tcam.width, tcam.height, tcam.znear, tcam.zfar) == (jcam.width, jcam.height,
                                                                jcam.znear, jcam.zfar)


# ------------------------------------------------------------ (b) a step ----


@pytest.mark.parametrize("scene", SCENES)
def test_bench_step_matches_jax(scenes, scene):
    (js, jcam, jgt), (_, tcam, tgt) = scenes[scene]
    mcfg, ocfg, pcfg = tbench.bench_configs(scene, auto=False)
    jm, jo, jp = jax_configs(scene)
    assert (mcfg.kernel_size, ocfg.regularization_from_iter) == (jm.kernel_size,
                                                                 jo.regularization_from_iter)
    assert (pcfg.max_per_tile, pcfg.instance_multiplier, pcfg.instance_budget) == \
        (jp.max_per_tile, jp.instance_multiplier, jp.instance_budget)
    jnew, jmet = jax_step(js, jcam, jgt, (jm, jo, jp))
    step = tloop.make_train_step(mcfg, ocfg, pcfg, spatial_lr_scale=5.0)
    tnew, tmet = step(tloop.init_train_state(carry(js)), tcam, tgt, torch.zeros(3), 0,
                      tbench.WIDTH, tbench.HEIGHT)
    assert tnew.iteration == int(jnew.iteration) == 1
    close(jmet["loss"], tmet["loss"], 1e-5, msg="loss")
    for k in ("n_instances", "n_overflow", "tile_overflow"):
        assert int(jmet[k]) == int(tmet[k]), k
    assert int(tmet["n_overflow"]) == int(tmet["tile_overflow"]) == 0
    jg, tg = jnew.gaussians, tnew.gaussians
    for k in PARAMS:  # m after one step from zero moments is 0.1 g
        g = np.abs(np.asarray(getattr(jg.adam_m, k)) / 0.1)
        # no gradient at all (f_rest at SH degree 0, the rotation of isotropic
        # splats): every entry stays as it was
        sel = g > 1e-6 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        assert sel.any(), k
        close(np.asarray(getattr(jg.params, k))[sel], getattr(tg.params, k).numpy()[sel],
              1e-4, 1e-7, msg=k)


# ------------------------------------------------------- (c) the settle ----


def test_auto_settle_matches_jax_from_starved_config(scenes):
    (js, jcam, jgt), (_, tcam, tgt) = scenes["dense"]
    W, H = tbench.WIDTH, tbench.HEIGHT
    jm, jo, _ = jax_configs("dense")
    # bench.py:257-271 around the JAX autotune_pipeline
    pcfg = JPipelineConfig(**STARVED)
    jts, m0 = jax_step(js, jcam, jgt, (jm, jo, pcfg))
    want = [(pcfg.max_per_tile, pcfg.instance_budget)]
    for _ in range(8):
        pcfg2, changed = jloop.autotune_pipeline(
            pcfg, float(m0["n_overflow"]), float(m0["tile_overflow"]),
            float(m0["n_instances"]), js.capacity, shrink_check=True)
        if not changed:
            break
        pcfg = pcfg2
        step = jloop.make_train_step(jm, jo, pcfg, spatial_lr_scale=5.0)
        jts, m0 = step(jts, jcam, jgt, jnp.zeros(3), 0, W, H)
        want.append((pcfg.max_per_tile, pcfg.instance_budget))

    mcfg, ocfg, _ = tbench.bench_configs("dense", auto=True)

    def step_for(p):
        return tloop.make_train_step(mcfg, ocfg, p, spatial_lr_scale=5.0)

    start = PipelineConfig(**STARVED)
    ts, tm0 = step_for(start)(tloop.init_train_state(carry(js)), tcam, tgt, torch.zeros(3),
                              0, W, H)
    ts, tpcfg, _, tm, got = tbench.settle(ts, tcam, tgt, torch.zeros(3), start, step_for,
                                          js.capacity, tm0)
    assert got == want
    assert len(got) >= 3  # a budget round and a tile-only round
    assert (tpcfg.max_per_tile, tpcfg.instance_budget) == want[-1]
    assert ts.iteration == int(jts.iteration) == len(want)
    # settled: nothing dropped; after len(want) Adam steps the two states
    # have drifted by rounding, and a few borderline (Gaussian, tile) pairs
    # may differ
    for m in (tm, m0):
        assert int(m["n_overflow"]) == int(m["tile_overflow"]) == 0
    assert abs(int(tm["n_instances"]) - int(m0["n_instances"])) <= 1e-3 * int(m0["n_instances"])


# ---------------------------------------------------- (d) parity check ----


def test_parity_inputs_match_jax():
    """bench.py:156-187's prep and binning against ``parity_inputs``."""
    rng = np.random.default_rng(3)
    P, W, H = 2000, 256, 256
    cam = JCamera.look_at([0, 0.3, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.9, W, H)

    @jax.jit
    def prep_fn(xyz, scales, quat, op, feat):
        return j_preprocess(xyz, scales, quat, op, feat, sh_degree=0, camera=cam,
                            kernel_size=0.1)

    @jax.jit
    def bin_fn(p):
        return j_bin(p.xy, p.radius, p.depth, p.valid, W, H, instance_budget=1 << 15,
                     max_per_tile=512, conic=p.conic,
                     opacity=jnp.where(p.valid, p.opacity, 0.0), need_tile_gauss=False)

    jp = prep_fn(
        jnp.asarray(rng.normal(size=(P, 3)) * 0.9, jnp.float32),
        jnp.asarray(rng.uniform(0.02, 0.25, (P, 3)), jnp.float32),
        jnp.asarray(np.tile([1.0, 0, 0, 0], (P, 1)), jnp.float32),
        jnp.asarray(rng.uniform(0.05, 0.95, (P, 1)), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (P, 1, 3)), jnp.float32))
    jb = bin_fn(jp)
    tp, tb, tW, tH = tbench.parity_inputs("cpu")
    assert (tW, tH) == (W, H)
    assert (np.asarray(jp.valid) == tp.valid.numpy()).all()
    for k in ("xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
              "normal", "ts", "depth", "radius"):
        close(getattr(jp, k), getattr(tp, k), 1e-4, 1e-5, msg=k)
    for k in ("n_instances", "n_overflow", "tile_overflow", "max_tile_count"):
        assert int(getattr(jb, k)) == int(getattr(tb, k)), k
    count = np.asarray(jb.tile_count)
    assert (count == tb.tile_count.numpy()).all()
    jg, js_ = np.asarray(jb.gauss_id), np.asarray(jb.tile_start)
    tg, ts_ = tb.gauss_id.numpy(), tb.tile_start.numpy()
    for t in range(count.shape[0]):
        assert (jg[js_[t]:js_[t] + count[t]] == tg[ts_[t]:ts_[t] + count[t]]).all(), t


def test_parity_error_formula():
    """bench.py:203-214 on a hand example: forward abs, med_pos mismatch
    share, gradients relative to max |reference| (+ 1e-8)."""
    fwd_ref = {"weight": torch.tensor([1.0, 2.0]),
               "med_pos": torch.tensor([0, 1, 2, 3], dtype=torch.int32)}
    fwd = {"weight": torch.tensor([1.0, 2.25]),
           "med_pos": torch.tensor([0, 1, 2, 4], dtype=torch.int32)}
    assert tbench.parity_error(fwd, fwd_ref, {}, {}) == 0.25
    fwd["weight"] = torch.tensor([1.0, 2.1])
    fwd["med_pos"] = fwd_ref["med_pos"]
    np.testing.assert_allclose(tbench.parity_error(fwd, fwd_ref, {}, {}), 0.1, rtol=1e-6)
    g_ref = {"xy": torch.tensor([[4.0, -8.0]]), "ts": torch.tensor([0.0, 0.0])}
    g = {"xy": torch.tensor([[4.5, -8.0]]), "ts": torch.tensor([1e-10, 0.0])}
    np.testing.assert_allclose(tbench.parity_error(fwd_ref, fwd_ref, g, g_ref), 0.5 / 8.0,
                               rtol=1e-6)
    g["ts"] = torch.tensor([1e-8, 0.0])  # over a zero reference: 1e-8 / 1e-8
    np.testing.assert_allclose(tbench.parity_error(fwd_ref, fwd_ref, g, g_ref), 1.0,
                               rtol=1e-6)


def test_kernel_parity_check_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tbench.kernel_parity_check(device="cpu")


# ------------------------------------------------------- (e) the line ----


def jax_merged_line(argv, capsys):
    """The JAX bench's merged line (bench.py:orchestrate) for ``argv``, each
    scene's child replaced by ``inner_main`` in this process."""

    def run_scene(child_argv, timeout):
        args = argparse.Namespace(
            trace=None, scene=child_argv[child_argv.index("--scene") + 1],
            auto="--auto" in child_argv, no_parity="--no-parity" in child_argv)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jbench.inner_main(args)
        return json.loads(out.getvalue().strip().splitlines()[-1]), ""

    mp = pytest.MonkeyPatch()
    mp.setattr(jbench, "_run_scene", run_scene)
    try:
        args = argparse.Namespace(trace=None, scene="both", auto=False, no_parity=True)
        capsys.readouterr()
        assert jbench.orchestrate(args, argv) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        mp.undo()


def test_main_both_prints_the_jax_line(capsys):
    jrec = jax_merged_line(["--scene", "both", "--no-parity"], capsys)
    trec = tbench.main(["--scene", "both", "--no-parity", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == trec
    assert set(trec) == (set(jrec) - {"xla_compiles"}) | {"stages_ms", "stages_ms_dense"}
    for k in ("metric", "unit"):
        assert trec[k] == jrec[k] == {"metric": "rays_per_s_per_chip_fwd_bwd_1600x1200",
                                      "unit": "rays/s"}[k]
    for k in ("value", "value_dense"):
        assert trec[k] > 0 and jrec[k] > 0
    for k, v in (("vs_baseline", "value"), ("vs_baseline_dense", "value_dense")):
        assert trec[k] == round(trec[v] / tbench.BASELINE_RAYS_PER_S, 4)
    assert trec["compile_wall_s"] == trec["compile_wall_s_dense"] == 0.0  # nothing built
    assert trec["stages_ms"] is None and trec["stages_ms_dense"] is None  # no card: no events
    assert "kernel_parity_max_err" not in trec
    # the dense scene settles from the package defaults (--auto)
    assert any(line.startswith("# auto-tuned config: max_per_tile=") for line in lines)


def test_traces_and_the_breakdown_on_the_cpu(tmp_path, capsys):
    """``--trace`` writes a Chrome trace from both entries; on the CPU the
    breakdown times the host-clock step and measures no stage."""
    rec = tbench.main(["--scene", "100k", "--no-parity", "--device", "cpu",
                       "--trace", str(tmp_path)])
    assert rec["metric"] == "rays_per_s_per_chip_fwd_bwd_1600x1200" and rec["value"] > 0
    fields = tbreak.main(["--iters", "1", "--warmup", "0", "--device", "cpu",
                          "--trace", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-2]) == fields
    assert list(fields) == list(tbreak.KEYS) and fields["full"] > 0
    assert all(v is None for k, v in fields.items() if k != "full")
    for name in ("bench_100k", "breakdown_100k"):
        assert "traceEvents" in json.loads((tmp_path / f"{name}.json").read_text()), name


def test_device_busy_is_the_union_of_device_intervals():
    events = [{"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 1000.0},
              {"ph": "X", "cat": "kernel", "ts": 500.0, "dur": 1000.0},  # overlaps the first
              {"ph": "X", "cat": "gpu_memcpy", "ts": 3000.0, "dur": 500.0},
              {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 9000.0},  # host: not counted
              {"ph": "i", "cat": "kernel", "ts": 8000.0}]
    busy, span = tbench.device_busy_ms(events)
    np.testing.assert_allclose([busy, span], [1.99, 3.49])
    assert tbench.device_busy_ms(events[3:]) == (0.0, 0.0)


def test_main_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.main(["--scene", "100k", "--no-parity"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbreak.main(["--iters", "1"])


# -------------------------------------------------- (f) the breakdown ----


def synthetic_step():
    """(stage, ms) pairs of a step with every mark, each stage k + 1 ms."""
    return [(name, float(k + 1)) for k, name in enumerate(STEP_MARKS[1:])]


def test_breakdown_keys_in_jax_order_and_summing_to_the_span():
    fields = tbreak.stage_fields([synthetic_step()], 99.0)
    assert list(fields)[:len(JAX_KEYS)] == JAX_KEYS
    assert list(fields) == JAX_KEYS + ["instance_segments", "pack_aux", "event_span"]
    assert fields["full"] == 99.0
    pairs = synthetic_step()
    assert fields["event_span"] == sum(ms for _, ms in pairs)
    assert sum(fields[k] for k in tbreak.STAGES) == fields["event_span"]
    ms = dict(pairs[1:])  # every name but the render's "start" is unique
    assert fields["preprocess"] == pairs[0][1] + ms["preprocess"]
    assert fields["pack_align"] == ms["pack_features"]
    assert fields["loss_tail"] == ms["normalize"] + ms["render"] + ms["loss"]
    for key, mark in (("bwd_kernel_only", "bwd_walk"), ("bwd_reduction", "bwd_segment_sum"),
                      ("instance_segments", "instance_segments"), ("pack_aux", "pack_aux")):
        assert fields[key] == ms[mark], key
    assert fields["backward"] == sum(ms[m] for m in STEP_MARKS[9:16])
    assert fields["adam_stats"] == ms["adam"] + ms["stats"]


def test_breakdown_medians_over_steps_and_unknown_marks():
    slow = [(name, 3.0 * ms) for name, ms in synthetic_step()]
    fields = tbreak.stage_fields([synthetic_step(), slow, slow], 1.0)
    assert fields["blend_fwd"] == 3.0 * dict(synthetic_step())["blend"]
    assert all(v is None for k, v in tbreak.stage_fields([], 2.0).items() if k != "full")
    assert tbreak.rounded({"a": 1.23456, "b": None}) == {"a": 1.23, "b": None}
    with pytest.raises(ValueError, match="densify"):
        tbreak.stage_fields([[("densify", 1.0)]], 1.0)


class FakeEvent:
    """``torch.cuda.Event`` stand-in for a CPU step: its time is the order
    of ``record``."""

    clock = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_a_cpu_step_makes_only_known_marks(scenes, monkeypatch):
    """Every mark a step makes on the CPU (the blend wrappers' own marks are
    on their kernel path) is one the breakdown maps, in ``STEP_MARKS``
    order."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    _, (ts, tcam, tgt) = scenes["100k"]
    step = tloop.make_train_step(*tbench.bench_configs("100k", False), spatial_lr_scale=5.0)
    events = []
    step(tloop.init_train_state(ts), tcam, tgt, torch.zeros(3), 0, tbench.WIDTH,
         tbench.HEIGHT, events=events)
    names = [n for n, _ in events]
    assert names == [m for m in STEP_MARKS if m not in tbreak.PIECE_OF
                     and m not in ("pack_features", "bwd_features")]
    fields = tbreak.stage_fields([tbreak.step_stages(events)], 5.0)
    assert fields["event_span"] == len(events) - 1
    assert sum(fields[k] for k in tbreak.STAGES) == fields["event_span"]


# ------------------------------------------------------- (g) on a card ----


@pytest.mark.cuda
def test_kernel_parity_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert tbench.kernel_parity_check("cuda") <= 1e-4


@pytest.mark.cuda
def test_step_marks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state, cam, gt = tbench.build_scene(scene="100k", device="cuda")
    step = tloop.make_train_step(*tbench.bench_configs("100k", False), spatial_lr_scale=5.0)
    events = []
    step(tloop.init_train_state(state), cam, gt, torch.zeros(3, device="cuda"), 0,
         tbench.WIDTH, tbench.HEIGHT, events=events)
    torch.cuda.synchronize()
    assert [n for n, _ in events] == STEP_MARKS
    fields = tbreak.stage_fields([tbreak.step_stages(events)], 1.0)
    assert all(v >= 0 for v in fields.values())
    np.testing.assert_allclose(sum(fields[k] for k in tbreak.STAGES), fields["event_span"],
                               rtol=1e-5)
