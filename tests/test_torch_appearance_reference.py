"""The port's train step with decoupled appearance (``make_train_step`` with
``ModelConfig(use_decoupled_appearance=True)``) against the benchmark's plain
reference of GOF's network and loss (``benchmark/reference/appearance.py``)
on seeded random weights, on the CPU: 400 splats at 64 x 48 (the crop 64 x
32, the network from 2 x 1 pixels), three steps over three views. The
reference draws the starting network and table (``init``), and the port is
fed them in its channel order (``to_port``); the port's own draw
(``init_appearance``) is held to the same distribution on its own.

The splats are shaped (log scales spread by a seeded normal of 0.3,
uniform rotations), as training leaves them: on round, unrotated splats
the plain reference's gradient departs from the port's by ~0.1% (ROADMAP
T10), which is the reference's and not the appearance path's.

Tolerances, from float32 arithmetic in different orders on the two sides
(the blend's sums, the SSIM filter, cuDNN-free CPU convolutions):

- the loss of each step, relative 1e-5: both sum ~3,000 pixels' terms in
  float32 in other orders (~1e-7 seen);
- each Gaussian group's gradient norm after step 1, relative 1e-4 (the
  blend's backward adds ~30 splats a pixel in another order; ~2e-7 seen);
- each network tensor's and the used embedding row's gradient after step
  1, elementwise, within 1e-4 of the tensor's largest entry: the same
  sums feed the network's backward (~5e-7 seen);
- the change over the three steps: each Gaussian group's norm and each
  network tensor's and used row's norm, relative 1e-3. Adam divides by
  the gradient's root mean square, so an entry whose gradient is ~1e-7 of
  its tensor's moves by a full step on either side of rounding; the norm
  over a group holds that to the few such entries (~2e-5 seen).

Each of the reference's three planted faults (D-SSIM on the transformed
crop, the next view's embedding row, no appearance Adam) fails the same
comparison. Alone, the reference's network with the program's weights
permuted to GOF's pixel-shuffle order equals the program's network.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import functional_call

from benchmark import jobs, program
from benchmark.reference import appearance as ra
from benchmark.reference import fp32
from benchmark.reference import scene as rs
from benchmark.reference import train as rt
from radegs_torch.models import appearance as pa
from radegs_torch.train import loop
from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

W, H = 64, 48
DEV = torch.device("cpu")
CFG = {"points": {"generator": "surface", "n": 400}, "capacity": 512, "scale_shrink": 1.0,
       "opacity": 0.8, "active_sh_degree": 3, "width": W, "height": H, "views": 3,
       "orbit": {"radius": 5.0, "elev": 0.8, "wave": 0.4, "fovx": 1.2, "fovy": 0.9},
       "kernel_size": 0.1, "spatial_lr_scale": 5.0}
LRS = (1e-3, 1e-3)  # network, embeddings (GOF's)
ORDER = [2, 0, 1]
TOL = {"loss": 1e-5, "grad": 1e-4, "app_grad": 1e-4, "change": 1e-3, "app_change": 1e-3}


def shaped_params(seed=3):
    from benchmark import scene

    pts, cols = scene.points_and_colors(CFG, seed)
    params = jobs.scene_params(CFG, pts, cols, DEV)
    n = params["xyz"].shape[0]
    rng = np.random.default_rng([seed, 4])
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params["scaling"] = params["scaling"] + torch.as_tensor(
        rng.normal(size=(n, 3)).astype(np.float32) * np.float32(0.3))
    params["rotation"] = torch.as_tensor(q)
    return params


@pytest.fixture(scope="module")
def sides():
    """(the program's record, the reference's inputs) of the three steps."""
    from benchmark import scene

    torch.manual_seed(0)
    params = shaped_params()
    eyes = scene.view_eyes(CFG)
    cams = program.cameras(eyes, CFG, DEV)
    gt = torch.rand((3, 3, H, W), generator=torch.Generator().manual_seed(9))
    state = program.load_state(CFG, params, cams, DEV)
    ts = loop.init_train_state(state, True, H, W, generator=torch.Generator().manual_seed(5))
    app0 = ra.init(torch.Generator().manual_seed(5))
    ts = ts.replace(app_params=ra.to_port(app0))
    step = loop.make_train_step(ModelConfig(kernel_size=0.1, use_decoupled_appearance=True),
                                OptimizationConfig(regularization_from_iter=0),
                                PipelineConfig(max_per_tile=1024, instance_budget=1 << 16), 5.0)
    p0 = {k: v.clone() for k, v in ts.gaussians.params.items()}
    prog = {"loss": []}
    for i, v in enumerate(ORDER):
        ts, m = step(ts, cams[v], gt[v], torch.zeros(3), v, W, H)
        assert float(m["n_overflow"]) == 0 and float(m["tile_overflow"]) == 0
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = rt.norms({k: x / (1 - rt.BETA1)
                                     for k, x in ts.gaussians.adam_m.items()})
            prog["app_grad"] = ra.from_port(loop.map_app(lambda x: x / (1 - rt.BETA1),
                                                         ts.app_m))
    n = state.n_active()
    prog["change"] = rt.norms({k: (x - p0[k])[:n] for k, x in ts.gaussians.params.items()})
    prog["app_change"] = ra.from_port(loop.map_app(lambda a, b: a - b, ts.app_params,
                                                   ra.to_port(app0)))
    return prog, (params, cams, gt, app0)


def reference(inputs, **kw):
    params, _, gt, app0 = inputs
    rcams = jobs.ref_cameras(jobs.scene.view_eyes(CFG), CFG, DEV)
    with fp32():
        f3 = rs.filter_3d(params["xyz"], rcams)
        app = app0
        tr = ra.Trainer(params, f3, 0.1, 3, 5.0, app, LRS, **kw)
        out = {"loss": []}
        for i, v in enumerate(ORDER):
            out["loss"].append(tr.step(rcams[v], gt[v], v))
            if i == 0:
                out["grad"] = rt.norms(tr.grads)
                out["app_grad"] = ra.map_tree(torch.clone, tr.app_grads)
        out["change"] = rt.norms({k: tr.params[k] - params[k] for k in rt.GROUPS})
        out["app_change"] = ra.map_tree(lambda a, b: a - b, tr.app, app)
    return out


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def tensor_gap(a, b):
    """The largest entry's gap over the tensor's largest entry."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def app_tensors(tree, rows):
    out = {f"net.{k}": v for k, v in tree["net"].items()}
    out.update({f"emb.{r}": tree["embeddings"][r] for r in rows})
    return out


def gaps(prog, ref):
    """The worst gap of each compared family."""
    g = ref["grad"]
    med = float(np.median(list(g.values())))
    kept = [k for k in g if g[k] >= 1e-3 * med]  # the SH rest's degree-0 groups aside
    pa_, ra_ = app_tensors(prog["app_grad"], ORDER[:1]), app_tensors(ref["app_grad"], ORDER[:1])
    ca = {k: float(v.double().norm()) for k, v in app_tensors(prog["app_change"], ORDER).items()}
    cr = {k: float(v.double().norm()) for k, v in app_tensors(ref["app_change"], ORDER).items()}
    return {
        "loss": max(rel(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad": max(rel(prog["grad"][k], g[k]) for k in kept),
        "app_grad": max(tensor_gap(pa_[k], ra_[k]) for k in ra_),
        "change": max(rel(prog["change"][k], ref["change"][k]) for k in kept),
        "app_change": max(rel(ca[k], cr[k]) for k in cr),
    }


def test_step_matches_the_reference(sides):
    prog, inputs = sides
    got = gaps(prog, reference(inputs))
    assert all(math.isfinite(v) and v <= TOL[k] for k, v in got.items()), got


@pytest.mark.parametrize("fault", ra.FAULTS)
def test_planted_faults_fail_the_comparison(sides, fault):
    prog, inputs = sides
    got = gaps(prog, reference(inputs, fault=fault))
    assert any(not v <= TOL[k] for k, v in got.items()), (fault, got)


@pytest.mark.parametrize("hw", [(1, 2), (3, 2)])
def test_permuted_reference_network_equals_the_programs(hw):
    """GOF's network with the reference's seeded weights equals the
    program's network with the same weights in its channel order, to
    float32 rounding (the same products, summed by the same CPU
    convolution); ``from_port`` undoes ``to_port``."""
    app = ra.init(torch.Generator().manual_seed(7))
    port = ra.to_port(app)
    back = ra.from_port(port)
    assert all(torch.equal(back["net"][k], v) for k, v in app["net"].items())
    assert torch.equal(back["embeddings"], app["embeddings"])
    x = torch.randn((1, 3 + pa.EMBED_DIM, *hw), generator=torch.Generator().manual_seed(8))
    want = ra.network(app["net"], x)
    got = functional_call(pa.NETWORK, port["net"], (x,))
    assert got.shape == (1, 3, 32 * hw[0], 32 * hw[1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # without the permutation the two are different functions
    plain = {f"{p_}.{part}": app["net"][f"{g}.{part}"] for g, p_ in ra.LAYERS.items()
             for part in ("weight", "bias")}
    assert float((functional_call(pa.NETWORK, plain, (x,)) - want).abs().max()) > 1e-4


def test_port_init_draws_the_reference_distribution():
    """The port's own starting network and table (``init_appearance``,
    which the benchmark replaces by the reference's draw) have the
    reference's shapes and distribution: zero biases; weights within the
    truncation's +-2 std of sqrt(1 / fan-in) / 0.8796 and of sample std
    sqrt(1 / fan-in) (within 15%: the smallest tensor, conv_out, has 432
    entries, a ~4% standard error); the table N(0, 1e-4^2) (131,072
    entries: mean within 1e-6, std within 2%). Both draws read alike."""
    _, port = pa.init_appearance(torch.Generator().manual_seed(11))
    ref = ra.to_port(ra.init(torch.Generator().manual_seed(12)))
    assert set(port["net"]) == set(ref["net"])
    for k, w in port["net"].items():
        assert w.shape == ref["net"][k].shape, k
        if k.endswith("bias"):
            assert not w.any() and not ref["net"][k].any(), k
            continue
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        want = fan_in ** -0.5
        for x in (w, ref["net"][k]):
            assert float(x.abs().max()) <= 2 * want / pa.TRUNC_STD * (1 + 1e-6), k
            assert abs(float(x.std()) / want - 1) < 0.15, (k, float(x.std()), want)
    for e in (port["embeddings"], ref["embeddings"]):
        assert e.shape == (pa.NUM_EMBEDDINGS, pa.EMBED_DIM)
        assert abs(float(e.mean())) < 1e-6 and abs(float(e.std()) / 1e-4 - 1) < 0.02
