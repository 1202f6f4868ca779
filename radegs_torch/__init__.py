"""radegs_torch — RaDe-GS on PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of ``radegs_tpu``, with the same sub-package layout
so each module's JAX original is found by name:

- ``core``     — cameras, SH colour, covariance / EWA projection and the
                 RaDe-GS ray-space plane / normal derivation.
- ``ops``      — tile binning (a 64-bit ``[tile | depth]`` key sort), the
                 forward and backward blend (hand-written CUDA kernels and
                 their plain PyTorch versions), the differentiable rasterizer
                 around them, SSIM / L1 losses and the KNN scale init.
- ``models``   — the Gaussian parameter store, densification, PLY I/O and
                 the decoupled-appearance network.
- ``train``    — configuration, argument parsing, Adam and the single-card
                 training loop.
- ``mesh``     — TSDF, Marching Tetrahedra, unbounded extraction, culling.
- ``data``     — COLMAP / Blender readers and the ``Scene``.
- ``scripts``  — the command-line entry points (``python -m
                 radegs_torch.scripts.train`` and the others).
- ``native``   — the nvcc build of the CUDA sources under ``csrc/``.
- ``utils``    — device selection, PLY and PNG I/O (no PIL), checkpoints,
                 camera paths.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit ``"cpu"`` they raise. This package imports neither
JAX nor ``radegs_tpu``.
"""

__version__ = "0.1.0"
