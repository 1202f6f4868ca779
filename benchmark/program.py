"""The system under test, driven through its public entries: the scene
state as a user loads one (``load_gaussian_ply``'s layout, then
``update_3d_filter``), the train step of ``make_train_step``, the work-buffer
policy ``autotune_pipeline`` and ``renderer.render``.
"""

from __future__ import annotations

import torch

from benchmark import scene as sc


def cameras(eyes, cfg: dict, device):
    from radegs_torch.core.camera import Camera

    o = cfg["orbit"]
    return [Camera.look_at(e, [0, 0, 0], [0, 1, 0], o["fovx"], o["fovy"], cfg["width"],
                           cfg["height"], device=device) for e in eyes]


def load_state(cfg: dict, params: dict, train_cams, device):
    """The scene as a viewer loads a trained one: the benchmark's arrays
    (``params``, the reference's names, which are the program's) in the
    first rows of a state at the configuration's capacity, as
    ``load_gaussian_ply`` lays them out, SH at ``active_sh_degree``, the 3D
    filter from the training cameras."""
    from radegs_torch.models import gaussian_model as gm

    n = params["xyz"].shape[0]
    state = gm.empty_state(cfg["capacity"], 3, device=device)

    def put(dst, src):
        out = dst.clone()
        out[:n] = src
        return out

    p = state.params
    p = gm.GaussianParams(**{k: put(getattr(p, k), params[k]) for k, _ in p.items()})
    active = state.active.clone()
    active[:n] = True
    state = state.replace(params=p, active=active, active_sh_degree=cfg["active_sh_degree"])
    return gm.update_3d_filter(state, train_cams)


def configs(cfg: dict):
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig

    return (ModelConfig(kernel_size=cfg["kernel_size"]),
            OptimizationConfig(regularization_from_iter=0), PipelineConfig(**cfg["pipeline"]))


@torch.no_grad()
def demand(state, cams, kernel_size: float):
    """Over the views: the largest instance count and the longest tile list
    that the program's binning meets (its preprocess and binning alone, at
    the largest budget, so nothing is cut before it is counted)."""
    from radegs_torch.ops.binning import MAX_INSTANCE_BUDGET
    from radegs_torch.ops.rasterize import bin_prep
    from radegs_torch.renderer import prepare

    peak = tile = 0
    for cam in cams:
        b = bin_prep(prepare(state, cam, kernel_size), cam.width, cam.height,
                     MAX_INSTANCE_BUDGET, 1, need_tile_gauss=False)
        peak, tile = max(peak, int(b.n_instances)), max(tile, int(b.max_tile_count))
    return peak, tile


def settle_train(pcfg, capacity: int, peak: int, tile: int, rounds: int = 8):
    """The training loop's budget policy (``autotune_pipeline`` with the
    shrink check) applied to the views' demand until it changes nothing."""
    from radegs_torch.train.loop import autotune_pipeline, instance_budget

    for _ in range(rounds):
        n_ovf = max(peak - instance_budget(pcfg, capacity), 0)
        t_ovf = float(tile > pcfg.max_per_tile)
        pcfg, changed = autotune_pipeline(pcfg, float(n_ovf), t_ovf, float(peak), capacity,
                                          shrink_check=True)
        if not changed:
            break
    return pcfg


def settle_serve(capacity: int, peak: int, tile: int, max_per_tile: int):
    """``render``'s own sizing for the largest demand of the views: (instance
    budget, max_per_tile)."""
    from radegs_torch.ops.binning import MAX_PER_TILE_CAP, default_instance_budget, round_budget

    budget = max(default_instance_budget(capacity), round_budget(peak))
    mpt = min(max(max_per_tile, 1 << (tile - 1).bit_length()), MAX_PER_TILE_CAP)
    return budget, mpt


def inputs(cfg: dict, seed: int, device):
    """Points, colours, training eyes and ground truth of the run."""
    pts, cols = sc.points_and_colors(cfg, seed)
    return pts, cols, sc.view_eyes(cfg), sc.ground_truth(cfg, seed, device)
