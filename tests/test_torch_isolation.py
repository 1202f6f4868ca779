"""The port stands alone: no module of ``radegs_torch`` (nor ``chip_smoke.py``)
imports JAX, flax or the JAX package, and its entry points refuse to run
on a machine without CUDA unless the caller asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.models import gaussian_model as gm
from radegs_torch.renderer import render

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "radegs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "radegs_tpu"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not imported_roots(path) & BANNED


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 32, 32, device="cpu")
    rng = np.random.default_rng(0)
    C = 16
    state = gm.state_from_arrays(rng.normal(size=(C, 3)), np.zeros((C, 1, 3)),
                                 np.zeros((C, 15, 3)), np.full((C, 3), -2.0),
                                 np.tile([1.0, 0, 0, 0], (C, 1)), np.zeros((C, 1)),
                                 np.ones(C, bool), np.zeros((C, 1)), 3, device="cpu")
    path = str(tmp_path / "s.ply")
    gm.save_gaussian_ply(path, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gm.load_gaussian_ply(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(state, cam, [0, 0, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 32, 32)
    loaded = gm.load_gaussian_ply(path, device="cpu")
    out = render(loaded, cam, [0, 0, 0], device="cpu")
    assert torch.isfinite(out["render"]).all()


def test_rasterize_refuses_inputs_that_require_grad():
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 0.9, 0.9, 32, 32, device="cpu")
    C = 8
    state = gm.state_from_arrays(np.random.default_rng(1).normal(size=(C, 3)),
                                 np.zeros((C, 1, 3)), np.zeros((C, 15, 3)),
                                 np.full((C, 3), -2.0), np.tile([1.0, 0, 0, 0], (C, 1)),
                                 np.zeros((C, 1)), np.ones(C, bool), np.zeros((C, 1)), 3,
                                 device="cpu")
    # the forward-only guard is gone since the backward blend exists: inputs
    # that require grad are differentiated, not refused or silently detached
    state.params.xyz.requires_grad_(True)
    out = render(state, cam, [0, 0, 0], device="cpu")
    out["render"].sum().backward()
    assert state.params.xyz.grad is not None
    assert torch.isfinite(state.params.xyz.grad).all() and state.params.xyz.grad.abs().sum() > 0
    with torch.no_grad():
        ref = render(state, cam, [0, 0, 0], device="cpu")["render"]
    assert torch.equal(ref, out["render"].detach())
