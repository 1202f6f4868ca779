"""Camera paths for turntable / video rendering (port of
``radegs_tpu/utils/trajectories.py``; reference utils/render_utils.py:1-281:
ellipse paths around a scene). Frames are written as PNG by
``utils/image.py`` (no PIL)."""

from __future__ import annotations

import os

import numpy as np
import torch

from radegs_torch.core.camera import Camera


def ellipse_path(cameras, n_frames: int = 120, z_variation: float = 0.0, z_phase: float = 0.0):
    """Fit an ellipse through the camera centres (in the camera ring's plane)
    and return ``n_frames`` look-at cameras toward the ring's centre, with
    the first camera's intrinsics and device."""
    centers = np.stack([c.camera_center.detach().cpu().numpy() for c in cameras])
    centers = centers.astype(np.float64)
    focus = centers.mean(axis=0)
    offsets = centers - focus
    _, _, vt = np.linalg.svd(offsets, full_matrices=False)  # the ring's principal plane
    a1, a2 = vt[0], vt[1]
    up = np.cross(a1, a2)
    # keep 'up' pointing like the cameras' average up (-y columns of R)
    avg_up = -np.stack([c.R.detach().cpu().numpy()[:, 1] for c in cameras]).mean(axis=0)
    if np.dot(up, avg_up) < 0:
        up = -up
    u, v = offsets @ a1, offsets @ a2
    ra, rb = np.percentile(np.abs(u), 90), np.percentile(np.abs(v), 90)
    h = offsets @ up
    ref = cameras[0]
    out = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        z = z_variation * np.sin(th + z_phase) * np.std(h)
        eye = focus + ra * np.cos(th) * a1 + rb * np.sin(th) * a2 + (np.mean(h) + z) * up
        out.append(Camera.look_at(eye, focus, up, float(ref.fovx), float(ref.fovy), ref.width,
                                  ref.height, device=ref.device))
    return out


@torch.no_grad()
def render_path(state, cameras, bg, out_dir, kernel_size=0.0, max_per_tile=512,
                save_depth=False):
    """Render a camera path to numbered PNGs (``00000.png``, and with
    ``save_depth`` a turbo-coloured median depth ``00000_depth.png``); assemble
    them with any ffmpeg."""
    from radegs_torch.renderer import render
    from radegs_torch.utils.image import write_png
    from radegs_torch.utils.vis import apply_depth_colormap

    os.makedirs(out_dir, exist_ok=True)
    for i, cam in enumerate(cameras):
        out = render(state, cam, bg, kernel_size=kernel_size, max_per_tile=max_per_tile,
                     device=state.device)
        img = np.clip(out["render"].cpu().numpy(), 0, 1).transpose(1, 2, 0)
        write_png(os.path.join(out_dir, f"{i:05d}.png"), (img * 255).astype(np.uint8))
        if save_depth:
            dc = apply_depth_colormap(out["median_depth"][0].cpu().numpy(),
                                      out["mask"][0].cpu().numpy())
            write_png(os.path.join(out_dir, f"{i:05d}_depth.png"), (dc * 255).astype(np.uint8))
    return out_dir
