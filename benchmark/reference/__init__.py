"""The plain reference of the benchmark's comparison: RaDe-GS's scene
set-up, renderer and training step in plain PyTorch. It imports nothing of
the program and takes nothing the program made."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """Matrix products and convolutions in full float32 (no TF32) inside."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
