"""The reference training step of RaDe-GS (train.py:124-188 of the
published code), in plain PyTorch: render, L1 + D-SSIM + the depth-normal
consistency term, gradients by autograd (through the blend block by
block), Adam with eps 1e-15 over the six parameter groups, and the
densification statistics (the screen-gradient norm, the abs screen
gradient, its max, the visible count and the largest radius).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import render as rr

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
GROUPS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
STATS = ("grad_accum", "grad_abs_accum", "grad_abs_max", "denom", "max_radii2d")
# OptimizationParams defaults (arguments/__init__.py:76-99)
LR = {"f_dc": 0.0025, "f_rest": 0.0025 / 20.0, "opacity": 0.05, "scaling": 0.005,
      "rotation": 0.001}
POSITION_LR = (0.00016, 0.0000016, 30_000)  # init, final, max steps
LAMBDA_DSSIM, LAMBDA_DN, DEPTH_RATIO = 0.2, 0.05, 0.6


def xyz_lr(step: int, spatial_lr_scale: float) -> float:
    """The exponential log-lerp of the position learning rate, float32."""
    f32 = torch.float32
    lr_i, lr_f, n = POSITION_LR
    t = torch.clamp(torch.tensor(step, dtype=f32) / n, 0.0, 1.0)
    return float(torch.exp(torch.log(torch.tensor(lr_i * spatial_lr_scale, dtype=f32)) * (1 - t)
                           + torch.log(torch.tensor(lr_f * spatial_lr_scale, dtype=f32)) * t))


def _gauss_taps(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(a, b):
    """Mean SSIM, 11-tap Gaussian window (sigma 1.5), zero padding."""
    C = a.shape[0]
    w = torch.as_tensor(_gauss_taps(), device=a.device)
    x = torch.cat([a, b, a * a, b * b, a * b])[None]
    n = x.shape[1]
    x = F.conv2d(x, w.reshape(1, 1, 11, 1).expand(n, 1, 11, 1), padding=(5, 0), groups=n)
    f = F.conv2d(x, w.reshape(1, 1, 1, 11).expand(n, 1, 1, 11), padding=(0, 5), groups=n)[0]
    mu1, mu2 = f[:C], f[C:2 * C]
    s1, s2, s12 = f[2 * C:3 * C] - mu1 * mu1, f[3 * C:4 * C] - mu2 * mu2, f[4 * C:] - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))


def depth_normals(cam, depth):
    """(3, H, W) unit normals of a depth map's back-projected points by
    central differences (graphics_utils.py:97-126), zero on the border."""
    H, W = cam.height, cam.width
    dev = depth.device
    gx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 - W / 2.0) / cam.focal_x
    gy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5 - H / 2.0) / cam.focal_y
    rays = torch.stack([gx[None, :].expand(H, W), gy[:, None].expand(H, W),
                        torch.ones((H, W), device=dev)], dim=0)
    p = depth.reshape(1, H, W) * rays
    n = torch.linalg.cross(p[:, 2:, 1:-1] - p[:, :-2, 1:-1], p[:, 1:-1, 2:] - p[:, 1:-1, :-2],
                           dim=0)
    n2 = torch.sum(torch.square(n), dim=0, keepdim=True)
    ok = n2 > 1e-24
    return F.pad(n * torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0),
                 (1, 1, 1, 1))


def loss_of(maps, gt, cam, rows=None):
    """L1 + D-SSIM (lambda 0.2) + 0.05 x the depth-normal term over the
    expected (0.4) and median (0.6) depths. ``rows``, a slice, keeps only
    those image rows (a fault for the check's own tests)."""
    img, nrm = maps["render"], maps["normal"]
    d1, d2 = depth_normals(cam, maps["expected_depth"]), depth_normals(cam, maps["median_depth"])
    if rows is not None:
        img, gt, nrm, d1, d2 = (x[:, rows] for x in (img, gt, nrm, d1, d2))
    l1 = torch.mean(torch.abs(img - gt))
    e1 = torch.mean(1.0 - torch.sum(nrm * d1, dim=0))
    e2 = torch.mean(1.0 - torch.sum(nrm * d2, dim=0))
    dn = (1 - DEPTH_RATIO) * e1 + DEPTH_RATIO * e2
    return (1.0 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1.0 - ssim(img, gt)) + LAMBDA_DN * dn


class Trainer:
    """Training on one scene from its initial parameters: ``step(cam, gt)``
    takes one step and returns its loss; ``grads`` holds the last step's
    gradients, ``params`` and ``stats`` the state.

    ``fault`` plants one fault, for the check's own calibration: "half"
    takes the loss over the top half of the rows, "altered" scales the
    colour gradient by 1.5 where the blend produces it."""

    def __init__(self, params, filter3d, kernel_size: float, active_degree: int,
                 spatial_lr_scale: float, dtype=torch.float32, fault: str | None = None):
        self.params = {k: params[k].detach().clone() for k in GROUPS}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        P = self.params["xyz"].shape[0]
        dev = self.params["xyz"].device
        self.stats = {k: torch.zeros((P,), dtype=torch.float32, device=dev) for k in STATS}
        self.filter3d = filter3d
        self.kernel_size = kernel_size
        self.active_degree = active_degree
        self.spatial_lr_scale = spatial_lr_scale
        self.dtype = dtype
        self.fault = fault
        self.it = 0
        self.grads = None

    def step(self, cam, gt) -> float:
        self.it += 1
        W, H = cam.width, cam.height
        p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        off = torch.zeros_like(p["xyz"][:, :2], requires_grad=True)
        # a splat the view culls gets no gradient (preprocessCUDA returns
        # early for it): its rows enter detached, so no 0 x inf of its
        # culled arithmetic reaches the parameters
        with torch.no_grad():
            seen = rr.preprocess(self.params, self.filter3d, cam, self.kernel_size,
                                 self.active_degree)["valid"]
        kept = {k: torch.where(seen.reshape((-1,) + (1,) * (v.dim() - 1)), v, v.detach())
                for k, v in p.items()}
        prep = rr.preprocess(kept, self.filter3d, cam, self.kernel_size, self.active_degree,
                             xy_offset=off)
        raw, lists = rr.raw_maps(prep, W, H, self.dtype)
        raw = {k: v.requires_grad_(True) for k, v in raw.items()}
        rows = slice(0, H // 2) if self.fault == "half" else None
        loss = loss_of(rr.normalize(raw, cam), gt, cam, rows)
        loss.backward()
        feats = rr.blend_features(prep)
        leaf = {k: v.detach().requires_grad_(True) for k, v in feats.items()}
        abs_grad = rr.backward_blocks(leaf, lists, {k: v.grad for k, v in raw.items()}, W,
                                      self.dtype, ndc_half=(W * 0.5, H * 0.5))
        g_feat = {k: leaf[k].grad if leaf[k].grad is not None else torch.zeros_like(leaf[k])
                  for k in feats}
        if self.fault == "altered":
            g_feat["rgb"] = g_feat["rgb"] * 1.5
        torch.autograd.backward([feats[k] for k in feats], [g_feat[k] for k in feats])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in p.items()}
        self.grads = grads
        with torch.no_grad():
            self._adam(grads)
            vis = prep["valid"] & (prep["radius"] > 0)
            s = self.stats
            gn = torch.linalg.vector_norm(off.grad * torch.tensor([W * 0.5, H * 0.5],
                                                                  device=off.device), dim=-1)
            ab = torch.where(vis, abs_grad, 0.0)
            s["grad_accum"] = s["grad_accum"] + torch.where(vis, gn, 0.0)
            s["grad_abs_accum"] = s["grad_abs_accum"] + ab
            s["grad_abs_max"] = torch.maximum(s["grad_abs_max"], ab)
            s["denom"] = s["denom"] + vis.to(torch.float32)
            s["max_radii2d"] = torch.where(vis, torch.maximum(s["max_radii2d"], prep["radius"]),
                                           s["max_radii2d"])
        return float(loss.detach())

    def _adam(self, grads):
        bc1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** self.it)
        bc2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** self.it)
        lrs = dict(LR, xyz=xyz_lr(self.it, self.spatial_lr_scale))
        for k in GROUPS:
            g = grads[k]
            self.m[k] = BETA1 * self.m[k] + (1 - BETA1) * g
            self.v[k] = BETA2 * self.v[k] + (1 - BETA2) * g * g
            self.params[k] = self.params[k] - lrs[k] * (self.m[k] / bc1) / (
                torch.sqrt(self.v[k] / bc2) + ADAM_EPS)


def norms(tensors: dict) -> dict:
    """Each tensor's L2 norm, in float64."""
    return {k: math.sqrt(float(torch.sum(torch.square(v.double())))) for k, v in tensors.items()}
