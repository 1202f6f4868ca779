"""radegs_torch — RaDe-GS on PyTorch and CUDA for NVIDIA Hopper.

The PyTorch counterpart of ``radegs_tpu``, with the same sub-package layout
so each module's JAX original is found by name:

- ``core``     — cameras, SH colour, covariance / EWA projection and the
                 RaDe-GS ray-space plane / normal derivation.
- ``ops``      — tile binning (a 64-bit ``[tile | depth]`` key sort), the
                 forward and backward blend (hand-written CUDA kernels and
                 their plain PyTorch versions), the differentiable rasterizer
                 around them, SSIM / L1 losses and the KNN scale init.
- ``models``   — the Gaussian parameter store, densification and PLY I/O.
- ``train``    — configuration, Adam and the single-card training loop.
- ``native``   — the nvcc build of the CUDA sources under ``csrc/``.
- ``utils``    — device selection and a numpy-only PLY reader/writer.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit ``"cpu"`` they raise. This package imports neither
JAX nor ``radegs_tpu``.
"""

__version__ = "0.1.0"
