"""Configuration dataclasses (port of ``radegs_tpu/train/config.py``),
mirroring the reference's argument groups (arguments/__init__.py:47-99) with
the JAX package's defaults."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """ModelParams (arguments/__init__.py:47-67)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    kernel_size: float = 0.0  # 2D Mip filter
    use_coord_map: bool = False
    use_decoupled_appearance: bool = False
    disable_filter3D: bool = False
    eval: bool = False
    data_device: str = "cuda"


@dataclass(frozen=True)
class PipelineConfig:
    """PipelineParams (arguments/__init__.py:69-74) and the rasterizer's
    work buffers."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    max_per_tile: int = 512
    instance_multiplier: int = 8
    # explicit instance budget (0 = derive from capacity x multiplier); the
    # training loop's autotune pins it to the measured peak demand rounded
    # to a budget bucket (ops/binning.round_budget)
    instance_budget: int = 0
    # multi-rank training only: the per-rank cap on the visibility-compressed
    # gather (0 = lossless, capacity / world). The loop's autotune shrinks it
    # toward the measured worst-rank visible peak (n_vis_max) and grows it
    # back on n_vis_overflow.
    vis_capacity: int = 0
    tiles_per_block: int = 2  # tiles per CUDA block of the blend kernels


@dataclass(frozen=True)
class OptimizationConfig:
    """OptimizationParams (arguments/__init__.py:76-99)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    appearance_embeddings_lr: float = 0.001
    appearance_network_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_depth_normal: float = 0.05
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    regularization_from_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
