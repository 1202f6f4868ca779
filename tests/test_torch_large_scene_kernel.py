"""The card's side of ``test_torch_large_scene.py`` (torch only, so the
card's machine runs it: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_large_scene_kernel.py``): one tile stacked 20,000 splats
deep through both blend kernels at ``max_per_tile`` 2^15 against their plain
versions, and one binning of more than 2^24 instances, view 0 of the
``train-surface-6.1M`` cell's scene. Both skip without a card. The scene
helpers here are shared with the CPU tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import jobs, program, run
from radegs_torch import renderer
from radegs_torch.ops.binning import MAX_PER_TILE_CAP, budget_cap

CELL = "train-surface-6.1M"
SEED = 2147483659
DEEP = 20_000


def config(**kw):
    """The new cell's configuration with ``kw`` replaced."""
    _, cfg, _ = run.cell_inputs(run.load_json(f"{run.ROOT}/BENCHMARK.json"), CELL)
    return dict(cfg, **kw)


def deep_tile(device):
    """A 16 x 16 view of 20,000 faint small splats in depth: every one is
    binned into the one tile, and few pixels end, so the back of the list
    shows in every map."""
    rng = np.random.default_rng(11)
    pts = np.stack([rng.uniform(-0.4, 0.4, DEEP), rng.uniform(-0.4, 0.4, DEEP),
                    rng.uniform(-1.0, 1.0, DEEP)], 1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (DEEP, 3)).astype(np.float32)
    cfg = config(points={"generator": "surface", "n": DEEP}, capacity=1 << 15, width=16,
                 height=16, views=1, opacity=0.1,
                 orbit={"radius": 5.0, "elev": 0.0, "wave": 0.0, "fovx": 0.2, "fovy": 0.2})
    dist2 = torch.full((DEEP,), 0.03 ** 2)
    eye = [[0.0, 0.0, -5.0]]
    cams = program.cameras(eye, cfg, device)
    params = jobs.scene_params(cfg, pts, cols, device, dist2=dist2.to(device))
    state = program.load_state(cfg, params, cams, device)
    return cfg, pts, cols, cams[0], state, dist2


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_deep_tile_kernels_match_plain():
    """The blend kernels on the 20,000-deep tile at max_per_tile 2^15 against
    their plain versions: forward abs 1e-4, backward rel 1e-4 per field."""
    need_card()
    from radegs_torch.ops import blend
    from radegs_torch.core.projection import COLUMNS, column
    from radegs_torch.ops.rasterize import bin_prep

    dev = torch.device("cuda")
    cfg, _, _, cam, state, _ = deep_tile(dev)
    with torch.no_grad():
        prep = renderer.prepare(state, cam, cfg["kernel_size"])
    on_cpu = dataclasses.replace(prep, **{f.name: getattr(prep, f.name).cpu()
                                          for f in dataclasses.fields(prep)
                                          if torch.is_tensor(getattr(prep, f.name))})
    g = torch.Generator().manual_seed(5)
    cot = None
    outs = {}
    for p in (prep, on_cpu):
        b = bin_prep(p, 16, 16, 1 << 16, 1 << 15, need_tile_gauss=p is on_cpu)
        assert int(b.tile_overflow) == 0 and int(b.max_tile_count) > 1 << 14
        table = p.table.detach()
        fwd = blend.blend_forward(b, table, 16, 16)
        if cot is None:
            cot = {k: torch.randn(fwd[k].shape, generator=g) for k in blend.DIFF_KEYS}
        dev_cot = {k: v.to(p.xy.device) for k, v in cot.items()}
        grad = blend.blend_backward(b, table, fwd, dev_cot, 16, 16)
        outs[p.xy.device.type] = (fwd, {**{f: column(grad, f) for f in COLUMNS},
                                        "xy_abs": grad[:, blend.XY_ABS:]})
    (kf, kg), (pf, pg) = outs["cuda"], outs["cpu"]
    for k in blend.DIFF_KEYS:
        assert float((kf[k].cpu() - pf[k]).abs().max()) <= 1e-4, k
    assert torch.equal(kf["med_pos"].cpu(), pf["med_pos"])
    for k, v in pg.items():
        scale = max(float(v.abs().max()), 1e-6)
        assert float((kg[k].cpu() - v).abs().max()) <= 1e-4 * scale, k


@pytest.mark.cuda
def test_card_binning_past_2_24_instances():
    """View 0 of the 6.1M scene bins more than 2^24 instances at its capacity's
    budget: per-tile counts equal a bincount of the sorted tile ids, nothing
    dropped."""
    need_card()
    from radegs_torch.ops.rasterize import bin_prep

    dev = torch.device("cuda")
    cfg = config()
    pts, cols = jobs.scene.points_and_colors(cfg, SEED)
    cams = program.cameras(jobs.scene.view_eyes(cfg), cfg, dev)
    from benchmark.reference import scene as rs

    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=dev))
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, dev, dist2), cams, dev)
    with torch.no_grad():
        prep = renderer.prepare(state, cams[0], cfg["kernel_size"])
        b = bin_prep(prep, cfg["width"], cfg["height"], budget_cap(cfg["capacity"]),
                     MAX_PER_TILE_CAP, need_tile_gauss=False)
    n = int(b.n_instances)
    assert n > 1 << 24 and int(b.n_overflow) == 0 and int(b.tile_overflow) == 0
    T = b.tile_count.numel()
    counts = torch.bincount(b.tile_id.long(), minlength=T)
    assert torch.equal(counts.to(torch.int32), b.tile_count)
    assert int(b.gauss_id.numel()) == n - int(b.n_culled)
    assert torch.all(b.tile_id[1:] >= b.tile_id[:-1])
