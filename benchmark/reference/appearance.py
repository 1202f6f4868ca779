"""The reference training step of RaDe-GS with GOF's decoupled appearance
(``--use_decoupled_appearance``), in plain PyTorch, float32 with TF32 off
(the caller's ``fp32``), written from GOF's description:

- the network (GOF ``scene/appearance_network.py``): conv 67->256 and a
  ReLU; four blocks of ``F.pixel_shuffle`` x2, a 3x3 conv and a ReLU (to
  128, 64, 32, 16); a bilinear x2 (align corners); a 16->16 conv and a
  ReLU; a 16->3 conv and a sigmoid. Every conv 3x3, stride 1, padding 1;
- ``L1_loss_appearance`` (GOF ``train.py``): the render's centre crop to
  a multiple of 32, its x32 downsample, the view's 64-d embedding row
  concatenated to every pixel, the network, its output multiplying the
  crop, L1 against the ground truth's crop;
- the loss: (1 - 0.2) x that L1 + 0.2 x D-SSIM on the raw render + the
  depth-normal term (``train.loss_of``'s parts, composed here);
- Adam with eps 1e-15 over the six groups (``train.Trainer``) and, dense,
  over every network tensor and the whole embedding table, one step
  count for all, as GOF's single ``torch.optim.Adam``.

The starting network and table are drawn here from a seed (``init``), in
GOF's layout, and handed to both sides as data: the program gets them in
its own names and channel order (``to_port``).

Three departures from GOF, each to follow the system it is compared with:

- **Pixel-shuffle channel order.** ``F.pixel_shuffle`` reads output pixel
  (h r + i, w r + j) of channel c from input channel c r^2 + i r + j,
  GOF's order. The program orders the same channels (i r + j) C + c.
  ``to_port`` permutes the output channels (and biases) of each conv that
  feeds a shuffle to the program's order, and ``from_port`` back, so the
  two networks are the same function.
- **The downsample** is an antialiased bilinear (``antialias=True``,
  ``align_corners=False``), as the program's, where GOF calls an
  align-corners bilinear without antialiasing.
- **The initial weights** are drawn from a normal truncated at two
  standard deviations, std sqrt(1 / fan-in), with zero biases (flax's
  ``lecun_normal``, the program's recipe), where GOF keeps
  ``nn.Conv2d``'s default uniform; the table is N(0, 1e-4^2), as GOF's.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import render as rr
from benchmark.reference import train as rt

# GOF's layers, in order, and the program's name of each (data keys)
LAYERS = {"conv1": "conv_in", "up1.conv": "ups.0.conv", "up2.conv": "ups.1.conv",
          "up3.conv": "ups.2.conv", "up4.conv": "ups.3.conv", "conv2": "conv_mid",
          "conv3": "conv_out"}
# (Cout, Cin) of each layer: conv1 on the downsampled crop and the 64-d
# embedding, each upsample block's conv on a quarter of the channels
# before its shuffle
CHANNELS = {"conv1": (256, 67), "up1.conv": (128, 64), "up2.conv": (64, 32),
            "up3.conv": (32, 16), "up4.conv": (16, 8), "conv2": (16, 16), "conv3": (3, 16)}
TABLE = (2048, 64)  # GOF's embeddings: rows x width
# the layers whose output a pixel shuffle reads
SHUFFLED = ("conv1", "up1.conv", "up2.conv", "up3.conv")
R = 2  # the shuffle's factor
FAULTS = ("dssim_transformed", "other_row", "no_app_adam")


def init(generator: torch.Generator) -> dict:
    """A starting tree in GOF's names and layout, float32 on the
    generator's device: each 3x3 conv's weight from a normal truncated at
    +-2 std, std sqrt(1 / fan-in) / 0.8796 (the truncation's own std),
    zero biases, the table N(0, 1e-4^2)."""
    dev = generator.device
    net = {}
    for name, (cout, cin) in CHANNELS.items():
        std = (1.0 / (cin * 9)) ** 0.5 / 0.87962566103423978
        w = torch.empty((cout, cin, 3, 3), device=dev)
        net[f"{name}.weight"] = torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                                            generator=generator)
        net[f"{name}.bias"] = torch.zeros(cout, device=dev)
    emb = torch.randn(TABLE, generator=generator, device=dev) * 1e-4
    return {"net": net, "embeddings": emb}


def gof_order(x):
    """A shuffled conv's weight or bias from the program's channel order to
    GOF's: output channel c r^2 + k takes the program's k C + c."""
    n = x.shape[0]
    c = n // (R * R)
    perm = torch.arange(n, device=x.device).reshape(R * R, c).t().reshape(-1)
    return x[perm]


def port_order(x):
    """``gof_order``'s inverse: the program's channel k C + c takes GOF's
    c r^2 + k."""
    n = x.shape[0]
    c = n // (R * R)
    perm = torch.arange(n, device=x.device).reshape(c, R * R).t().reshape(-1)
    return x[perm]


def from_port(app: dict) -> dict:
    """The program's appearance tree (``{"net": {"<name>.weight",
    "<name>.bias"}, "embeddings"}``, its names and channel order) as the
    reference's: GOF's names and channel order, float32 copies."""
    net = {}
    for gof, port in LAYERS.items():
        for part in ("weight", "bias"):
            x = app["net"][f"{port}.{part}"].detach().float().clone()
            net[f"{gof}.{part}"] = gof_order(x) if gof in SHUFFLED else x
    return {"net": net, "embeddings": app["embeddings"].detach().float().clone()}


def to_port(app: dict) -> dict:
    """``from_port``'s inverse: a reference tree in the program's names and
    channel order, as copies."""
    net = {}
    for gof, port in LAYERS.items():
        for part in ("weight", "bias"):
            x = app["net"][f"{gof}.{part}"].detach().clone()
            net[f"{port}.{part}"] = port_order(x) if gof in SHUFFLED else x
    return {"net": net, "embeddings": app["embeddings"].detach().clone()}


def network(net: dict, x):
    """GOF's AppearanceNetwork: (1, 67, h, w) -> (1, 3, 32 h, 32 w)."""
    def conv(name, y):
        return F.conv2d(y, net[f"{name}.weight"], net[f"{name}.bias"], padding=1)

    y = F.relu(conv("conv1", x))
    for i in range(1, 5):
        y = F.relu(conv(f"up{i}.conv", F.pixel_shuffle(y, R)))
    y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
    y = F.relu(conv("conv2", y))
    return torch.sigmoid(conv("conv3", y))


def crop_box(H: int, W: int):
    """(top, left, Hc, Wc) of the centre crop to a multiple of 32."""
    Hc, Wc = H // 32 * 32, W // 32 * 32
    return H // 2 - Hc // 2, W // 2 - Wc // 2, Hc, Wc


def transform(net: dict, row, image):
    """The transformed centre crop of ``image`` (3, H, W) with embedding
    ``row`` (64,), and its box."""
    top, left, Hc, Wc = crop_box(*image.shape[1:])
    crop = image[:, top:top + Hc, left:left + Wc]
    down = F.interpolate(crop[None], size=(Hc // 32, Wc // 32), mode="bilinear",
                         antialias=True, align_corners=False)
    x = torch.cat([down, row[None, :, None, None].expand(1, row.shape[0], Hc // 32, Wc // 32)],
                  dim=1)
    return network(net, x)[0] * crop, (top, left, Hc, Wc)


def loss_of(maps, gt, cam, app, row: int, dssim_transformed: bool = False):
    """(1 - 0.2) L1 of the transformed crop + 0.2 D-SSIM of the raw render
    (with ``dssim_transformed``, a fault: of the transformed crop) + 0.05 x
    the depth-normal term."""
    img, nrm = maps["render"], maps["normal"]
    out, (top, left, Hc, Wc) = transform(app["net"], app["embeddings"][row], img)
    gt_crop = gt[:, top:top + Hc, left:left + Wc]
    l1 = torch.mean(torch.abs(out - gt_crop))
    d_ssim = 1.0 - (rt.ssim(out, gt_crop) if dssim_transformed else rt.ssim(img, gt))
    d1, d2 = rt.depth_normals(cam, maps["expected_depth"]), rt.depth_normals(cam, maps[
        "median_depth"])
    e1 = torch.mean(1.0 - torch.sum(nrm * d1, dim=0))
    e2 = torch.mean(1.0 - torch.sum(nrm * d2, dim=0))
    dn = (1 - rt.DEPTH_RATIO) * e1 + rt.DEPTH_RATIO * e2
    return (1.0 - rt.LAMBDA_DSSIM) * l1 + rt.LAMBDA_DSSIM * d_ssim + rt.LAMBDA_DN * dn


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN convolutions in TF32 inside the block when ``on`` (a control)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on or before
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def map_tree(fn, *trees):
    return {"net": {k: fn(*(t["net"][k] for t in trees)) for k in trees[0]["net"]},
            "embeddings": fn(*(t["embeddings"] for t in trees))}


class Trainer(rt.Trainer):
    """``train.Trainer`` with the appearance network: ``step(cam, gt,
    view)`` takes one step and returns its loss; ``app_grads`` holds the
    last step's network and embedding gradients, ``app`` the network
    (``init``'s tree, GOF's layout). ``lrs``: (network, embeddings)
    learning rates.

    ``tf32`` runs the step's cuDNN convolutions in TF32 (a control);
    ``fault`` plants one of ``FAULTS``: D-SSIM on the transformed crop,
    the next view's embedding row, or no appearance Adam."""

    def __init__(self, params, filter3d, kernel_size: float, active_degree: int,
                 spatial_lr_scale: float, app: dict, lrs, dtype=torch.float32,
                 tf32: bool = False, fault: str | None = None):
        super().__init__(params, filter3d, kernel_size, active_degree, spatial_lr_scale,
                         dtype=dtype)
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.app = map_tree(lambda x: x.detach().clone(), app)
        self.app_m = map_tree(torch.zeros_like, app)
        self.app_v = map_tree(torch.zeros_like, app)
        self.lrs = lrs
        self.tf32 = tf32
        self.app_fault = fault
        self.app_grads = None

    def step(self, cam, gt, view: int) -> float:
        with cudnn_tf32(self.tf32):
            return self._step(cam, gt, view)

    def _step(self, cam, gt, view: int) -> float:
        self.it += 1
        W, H = cam.width, cam.height
        p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        app = map_tree(lambda x: x.detach().requires_grad_(True), self.app)
        off = torch.zeros_like(p["xyz"][:, :2], requires_grad=True)
        # a splat the view culls gets no gradient (train.Trainer.step)
        with torch.no_grad():
            seen = rr.preprocess(self.params, self.filter3d, cam, self.kernel_size,
                                 self.active_degree)["valid"]
        kept = {k: torch.where(seen.reshape((-1,) + (1,) * (v.dim() - 1)), v, v.detach())
                for k, v in p.items()}
        prep = rr.preprocess(kept, self.filter3d, cam, self.kernel_size, self.active_degree,
                             xy_offset=off)
        raw, lists = rr.raw_maps(prep, W, H, self.dtype)
        raw = {k: v.requires_grad_(True) for k, v in raw.items()}
        n_rows = app["embeddings"].shape[0]
        row = (view + 1) % n_rows if self.app_fault == "other_row" else view
        loss = loss_of(rr.normalize(raw, cam), gt, cam, app, row,
                       dssim_transformed=self.app_fault == "dssim_transformed")
        loss.backward()
        feats = rr.blend_features(prep)
        leaf = {k: v.detach().requires_grad_(True) for k, v in feats.items()}
        abs_grad = rr.backward_blocks(leaf, lists, {k: v.grad for k, v in raw.items()}, W,
                                      self.dtype, ndc_half=(W * 0.5, H * 0.5))
        g_feat = {k: leaf[k].grad if leaf[k].grad is not None else torch.zeros_like(leaf[k])
                  for k in feats}
        torch.autograd.backward([feats[k] for k in feats], [g_feat[k] for k in feats])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in p.items()}
        self.grads = grads
        self.app_grads = map_tree(
            lambda x: x.grad if x.grad is not None else torch.zeros_like(x), app)
        with torch.no_grad():
            self._adam(grads)
            if self.app_fault != "no_app_adam":
                self._app_adam(self.app_grads)
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

    def _app_adam(self, grads):
        """Dense Adam over every network tensor and the whole table (rows
        without a gradient move with their moments), the step count shared
        with the Gaussians'."""
        bc1 = float(1.0 - torch.tensor(rt.BETA1, dtype=torch.float32) ** self.it)
        bc2 = float(1.0 - torch.tensor(rt.BETA2, dtype=torch.float32) ** self.it)

        def upd(p, g, m, v, lr):
            m = rt.BETA1 * m + (1 - rt.BETA1) * g
            v = rt.BETA2 * v + (1 - rt.BETA2) * g * g
            return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + rt.ADAM_EPS), m, v

        net_lr, emb_lr = self.lrs
        for k in self.app["net"]:
            self.app["net"][k], self.app_m["net"][k], self.app_v["net"][k] = upd(
                self.app["net"][k], grads["net"][k], self.app_m["net"][k],
                self.app_v["net"][k], net_lr)
        self.app["embeddings"], self.app_m["embeddings"], self.app_v["embeddings"] = upd(
            self.app["embeddings"], grads["embeddings"], self.app_m["embeddings"],
            self.app_v["embeddings"], emb_lr)


def norms(app: dict, rows) -> dict:
    """Each network tensor's L2 norm (``net.<name>``) and each of the
    embedding ``rows``' (``emb.<row>``), in float64."""
    out = {f"net.{k}": v for k, v in rt.norms(app["net"]).items()}
    out.update({f"emb.{r}": v for r, v in rt.norms(
        {r: app["embeddings"][r] for r in rows}).items()})
    return out
