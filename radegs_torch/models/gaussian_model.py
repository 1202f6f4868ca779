"""Gaussian parameter store with densification (port of
``radegs_tpu/models/gaussian_model.py``; reference GaussianModel,
scene/gaussian_model.py:27-747).

As in the JAX package, arrays are allocated at a fixed *capacity* C with an
``active`` mask, so a state carried across from JAX keeps its layout, and
densify / prune is a masked compaction into the same capacity; the capacity
doubles on the host when occupancy crosses 90% (``maybe_grow``). The Adam
moments live beside the parameters, so the reference's optimizer-state
surgery (gaussian_model.py:561-637) is the same gather applied to them.

Densification is the GOF strategy (gaussian_model.py:662-741): clone below
the size threshold, split (N = 2, scale / 1.6) above, gated by mean screen
gradient >= tau OR abs-gradient >= quantile Q; prune on opacity < min and
world size > 0.1 extent. A reference quirk is kept on purpose:
densification_postfix zeroes max_radii2D for every point
(gaussian_model.py:659), so the screen-size prune (gaussian_model.py:735)
can never fire in the same call, and is left out here too.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from radegs_torch.core.gaussians import compute_3d_filter, fuse_3d_filter, quat_to_rotmat
from radegs_torch.core.sh import num_sh_coeffs, rgb2sh
from radegs_torch.ops.knn import mean_dist2_knn
from radegs_torch.utils import ply as plyio
from radegs_torch.utils.device import resolve_device


@dataclass(frozen=True)
class GaussianParams:
    """The six optimisable tensors (scene/gaussian_model.py:47-69)."""

    xyz: torch.Tensor  # (C,3)
    f_dc: torch.Tensor  # (C,1,3)
    f_rest: torch.Tensor  # (C,M-1,3)
    scaling: torch.Tensor  # (C,3)  log-scales
    rotation: torch.Tensor  # (C,4)  unnormalised quaternion
    opacity: torch.Tensor  # (C,1)  logit

    def replace(self, **kw) -> "GaussianParams":
        return replace(self, **kw)

    def items(self):
        return [(f.name, getattr(self, f.name)) for f in fields(self)]

    def map(self, fn) -> "GaussianParams":
        """A GaussianParams of ``fn`` applied to each tensor."""
        return GaussianParams(**{k: fn(v) for k, v in self.items()})


@dataclass(frozen=True)
class GaussianState:
    params: GaussianParams
    active: torch.Tensor  # (C,) bool
    filter_3d: torch.Tensor  # (C,1)  Mip 3D filter width
    max_radii2d: torch.Tensor  # (C,)
    grad_accum: torch.Tensor  # (C,)  sum of ||dL/d ndc-mean2D||
    grad_abs_accum: torch.Tensor  # (C,)  sum of the GOF abs screen gradient
    grad_abs_max: torch.Tensor  # (C,)
    denom: torch.Tensor  # (C,)
    adam_m: GaussianParams
    adam_v: GaussianParams
    adam_step: int = 0
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    def n_active(self):
        return self.active.sum()

    def replace(self, **kw) -> "GaussianState":
        return replace(self, **kw)

    # ---- activations (scene/gaussian_model.py:29-45) ----
    def get_scaling(self):
        return torch.exp(self.params.scaling)

    def get_rotation(self):
        q = self.params.rotation
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def get_opacity(self):
        return torch.sigmoid(self.params.opacity)

    def get_features(self):
        return torch.cat([self.params.f_dc, self.params.f_rest], dim=1)

    def get_fused_scaling_opacity(self):
        """Mip-fused (scales, opacity) (gaussian_model.py:157-166)."""
        return fuse_3d_filter(self.get_scaling(), self.get_opacity(), self.filter_3d)


def round_capacity(n: int, minimum: int = 1 << 12) -> int:
    return max(minimum, 1 << int(np.ceil(np.log2(max(n, 1)))))


def empty_state(capacity: int, sh_degree: int = 3, device=None) -> GaussianState:
    dev = resolve_device(device)
    M = num_sh_coeffs(sh_degree)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    rotation = full((capacity, 4), 0.0)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=full((capacity, 3), 0.0),
        f_dc=full((capacity, 1, 3), 0.0),
        f_rest=full((capacity, M - 1, 3), 0.0),
        scaling=full((capacity, 3), -10.0),
        rotation=rotation,
        opacity=full((capacity, 1), -10.0),
    )
    return _with_fresh_stats(params, torch.zeros((capacity,), dtype=torch.bool, device=dev),
                             full((capacity, 1), 0.0), 0, sh_degree)


def _with_fresh_stats(params: GaussianParams, active, filter_3d, active_sh_degree: int,
                      max_sh_degree: int) -> GaussianState:
    """A state with zero densification statistics and Adam moments."""

    def zc():
        return torch.zeros_like(active, dtype=torch.float32)

    return GaussianState(
        params=params, active=active, filter_3d=filter_3d, max_radii2d=zc(),
        grad_accum=zc(), grad_abs_accum=zc(), grad_abs_max=zc(), denom=zc(),
        adam_m=params.map(torch.zeros_like), adam_v=params.map(torch.zeros_like),
        adam_step=0, active_sh_degree=active_sh_degree, max_sh_degree=max_sh_degree)


TRAINING_FIELDS = ("max_radii2d", "grad_accum", "grad_abs_accum", "grad_abs_max", "denom")


def state_from_arrays(xyz, f_dc, f_rest, scaling, rotation, opacity, active,
                      filter_3d, active_sh_degree: int, max_sh_degree: int | None = None,
                      device=None, training: dict | None = None) -> GaussianState:
    """Build a state from host arrays — e.g. a JAX state's fields taken as
    numpy (``np.asarray(jax_state.params.xyz)``, ...) — on ``device``.
    ``max_sh_degree`` defaults to the degree the ``f_rest`` width implies.

    ``training``: the training fields of a state mid-training, as host
    arrays: ``TRAINING_FIELDS`` (C,), ``adam_m`` / ``adam_v`` dicts keyed
    by the six parameter names, and ``adam_step``. Without it they start at
    zero."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    f_rest = f32(f_rest)
    if max_sh_degree is None:
        max_sh_degree = int(round((f_rest.shape[1] + 1) ** 0.5)) - 1
    params = GaussianParams(xyz=f32(xyz), f_dc=f32(f_dc), f_rest=f_rest,
                            scaling=f32(scaling), rotation=f32(rotation),
                            opacity=f32(opacity))
    state = _with_fresh_stats(params, torch.tensor(np.asarray(active, bool), device=dev),
                              f32(filter_3d), int(active_sh_degree), int(max_sh_degree))
    if training is None:
        return state
    return state.replace(
        **{k: f32(training[k]) for k in TRAINING_FIELDS},
        adam_m=GaussianParams(**{k: f32(v) for k, v in training["adam_m"].items()}),
        adam_v=GaussianParams(**{k: f32(v) for k, v in training["adam_v"].items()}),
        adam_step=int(training["adam_step"]))


def update_3d_filter(state: GaussianState, cameras) -> GaussianState:
    """Recompute the Mip 3D filter from the camera set
    (scene/gaussian_model.py:180-232)."""
    f = compute_3d_filter(state.params.xyz, cameras)
    return state.replace(filter_3d=torch.where(state.active[:, None], f, 0.0))


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def create_from_points(points, colors, sh_degree: int = 3, capacity: int | None = None,
                       device=None) -> GaussianState:
    """Initialise from a point cloud (scene/gaussian_model.py:301-328): scales
    from sqrt(mean 3-NN dist^2), opacity 0.1, identity rotation, DC colour
    from RGB. ``points``/``colors`` (P, 3) arrays or tensors."""
    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    P = points.shape[0]
    if capacity is None:
        capacity = round_capacity(P)
    state = empty_state(capacity, sh_degree, device=dev)

    dist2 = torch.clamp_min(mean_dist2_knn(points), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    opac = inverse_sigmoid(torch.full((P, 1), 0.1, dtype=torch.float32, device=dev))

    def put(dst, src):
        out = dst.clone()
        out[:P] = src
        return out

    p = state.params
    params = p.replace(xyz=put(p.xyz, points), f_dc=put(p.f_dc, rgb2sh(colors)[:, None, :]),
                       scaling=put(p.scaling, scales), opacity=put(p.opacity, opac))
    active = state.active.clone()
    active[:P] = True
    return state.replace(params=params, active=active)


def reset_3d_filter(state: GaussianState) -> GaussianState:
    return state.replace(filter_3d=torch.zeros_like(state.filter_3d))


def oneup_sh_degree(state: GaussianState) -> GaussianState:
    return state.replace(active_sh_degree=min(state.active_sh_degree + 1, state.max_sh_degree))


def add_densification_stats(state: GaussianState, xy_grad, xy_abs_grad,
                            visible) -> GaussianState:
    """Accumulate screen-gradient statistics (gaussian_model.py:743-747).
    xy_grad: (C, 2) dL/d NDC-scaled centre; xy_abs_grad: (C,) the GOF
    abs-gradient side channel (NDC-scaled); visible: (C,) radii > 0."""
    gnorm = torch.linalg.vector_norm(xy_grad, dim=-1)
    vis = visible & state.active
    abs_g = torch.where(vis, xy_abs_grad, 0.0)
    return state.replace(
        grad_accum=state.grad_accum + torch.where(vis, gnorm, 0.0),
        grad_abs_accum=state.grad_abs_accum + abs_g,
        grad_abs_max=torch.maximum(state.grad_abs_max, abs_g),
        denom=state.denom + vis.to(torch.float32),
    )


def update_max_radii(state: GaussianState, radii, visible) -> GaussianState:
    vis = visible & state.active
    return state.replace(max_radii2d=torch.where(
        vis, torch.maximum(state.max_radii2d, radii), state.max_radii2d))


def _masked_quantile(values, mask, q):
    """Quantile over the masked entries (torch.quantile's linear
    interpolation), without leaving the device."""
    v = torch.sort(torch.where(mask, values, torch.finfo(values.dtype).max)).values
    n = mask.sum()
    last = torch.clamp_min(n - 1, 0)
    pos = q * last.to(torch.float32)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, values.shape[0] - 1)
    hi = torch.clamp(lo + 1, 0, values.shape[0] - 1)
    frac = pos - lo.to(torch.float32)
    return v[lo] * (1 - frac) + v[torch.minimum(hi, last)] * frac


def normal_draws(generator: torch.Generator, capacity: int, device):
    """The three (C, 3) standard-normal draws of ``densify_and_prune``: the
    clone, split-A and split-B position samples."""
    return tuple(torch.randn((capacity, 3), generator=generator, device=device)
                 for _ in range(3))


def densify_and_prune(state: GaussianState, generator: torch.Generator | None,
                      max_grad: float, min_opacity: float, extent: float,
                      percent_dense: float = 0.01, prune_big_ws: bool = True, draws=None):
    """GOF densify + prune (gaussian_model.py:717-741) as a compaction into
    the same capacity. Candidates are laid out [originals | clone copies |
    split copy A | split copy B] and the kept ones move to the front in that
    order (a stable sort). ``draws``: the three (C, 3) normal samples
    (default ``normal_draws(generator, ...)``). Returns (state, stats) with
    stats {n_clone, n_split, n_prune, n_drop (capacity overflow), n_active}."""
    p = state.params
    C = state.capacity
    dev = state.device
    active = state.active

    denom = torch.clamp_min(state.denom, 1.0)
    grads = torch.where(state.denom > 0, state.grad_accum / denom, 0.0)
    grads_abs = torch.where(state.denom > 0, state.grad_abs_accum / denom, 0.0)
    ratio = (torch.where(active, (grads >= max_grad).to(torch.float32), 0.0).sum()
             / torch.clamp_min(active.to(torch.float32).sum(), 1.0))
    Q = _masked_quantile(grads_abs, active, 1.0 - ratio)

    scales = torch.exp(p.scaling)
    max_scale = scales.max(-1).values
    hot = active & ((grads >= max_grad) | (grads_abs >= Q))
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)

    prune_op = torch.sigmoid(p.opacity[:, 0]) < min_opacity
    ws_big = (max_scale > 0.1 * extent) & bool(prune_big_ws)

    R = quat_to_rotmat(p.rotation)
    if draws is None:
        draws = normal_draws(generator, C, dev)

    def sampled_xyz(eps):
        return p.xyz + (R * (eps * scales)[:, None, :]).sum(-1)

    # block 0: kept originals (split originals are consumed; pruned dropped)
    keep0 = active & ~split & ~(prune_op | ws_big)
    # block 1: clone copies at a sampled position (gaussian_model.py:698-704)
    keep1 = clone & ~(prune_op | ws_big)
    # blocks 2, 3: split copies, scale / (0.8 N) with N = 2 (gaussian_model.py:675-684)
    new_scaling = torch.log(scales / 1.6)
    ws_big_split = ((scales / 1.6).max(-1).values > 0.1 * extent) & bool(prune_big_ws)
    keep23 = split & ~(prune_op | ws_big_split)
    blocks = [p, p.replace(xyz=sampled_xyz(draws[0])),
              p.replace(xyz=sampled_xyz(draws[1]), scaling=new_scaling),
              p.replace(xyz=sampled_xyz(draws[2]), scaling=new_scaling)]
    keep_all = torch.cat([keep0, keep1, keep23, keep23])
    # stable order: kept entries first, in block order
    order = torch.sort((~keep_all).to(torch.uint8), stable=True).indices[:C]
    n_new = keep_all.sum()
    new_active = torch.arange(C, device=dev) < torch.clamp_max(n_new, C)

    def compact(blocks_list):
        return GaussianParams(**{k: torch.cat([getattr(b, k) for b in blocks_list])[order]
                                 for k, _ in p.items()})

    # Adam moments: kept originals carry theirs; new entries start at zero
    zeros = p.map(torch.zeros_like)
    new_filter = torch.cat([state.filter_3d] * 4)[order]  # refreshed by update_3d_filter
    zc = torch.zeros((C,), dtype=torch.float32, device=dev)
    stats = {
        "n_clone": keep1.sum(),
        "n_split": split.sum(),
        "n_prune": (active & (prune_op | ws_big)).sum(),
        "n_drop": torch.clamp_min(n_new - C, 0),
        "n_active": torch.clamp_max(n_new, C),
    }
    new_state = state.replace(
        params=compact(blocks),
        active=new_active,
        filter_3d=torch.where(new_active[:, None], new_filter, 0.0),
        max_radii2d=zc,  # reference postfix quirk (gaussian_model.py:659)
        grad_accum=zc,
        grad_abs_accum=zc,
        grad_abs_max=zc,
        denom=zc,
        adam_m=compact([state.adam_m, zeros, zeros, zeros]),
        adam_v=compact([state.adam_v, zeros, zeros, zeros]),
    )
    return new_state, stats


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to <= 0.01 accounting for the 3D filter
    (gaussian_model.py:495-513), and zero the opacity Adam moments
    (replace_tensor_to_optimizer, gaussian_model.py:561-576)."""
    s2 = torch.square(state.get_scaling())
    coef = torch.sqrt(torch.prod(s2, -1)
                      / torch.prod(s2 + torch.square(state.filter_3d), -1))[:, None]
    new = torch.clamp_max(state.get_opacity() * coef, 0.01) / torch.clamp_min(coef, 1e-10)
    new_logit = inverse_sigmoid(torch.clamp(new, 1e-7, 1 - 1e-7))
    return state.replace(
        params=state.params.replace(opacity=new_logit),
        adam_m=state.adam_m.replace(opacity=torch.zeros_like(new_logit)),
        adam_v=state.adam_v.replace(opacity=torch.zeros_like(new_logit)),
    )


def _per_slot(state: GaussianState, fn) -> GaussianState:
    """``fn`` applied to every per-slot tensor of the state."""
    return state.replace(
        params=state.params.map(fn), active=fn(state.active), filter_3d=fn(state.filter_3d),
        **{k: fn(getattr(state, k)) for k in TRAINING_FIELDS},
        adam_m=state.adam_m.map(fn), adam_v=state.adam_v.map(fn))


def resize_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """A state of capacity ``new_capacity``. Growing pads with zeroed,
    inactive slots (as the JAX package's ``jnp.pad``); shrinking compacts the
    active entries to the front and needs n_active <= new_capacity."""
    C = state.capacity
    if new_capacity == C:
        return state
    if new_capacity > C:
        def grow(x):
            return torch.cat([x, torch.zeros((new_capacity - C,) + x.shape[1:], dtype=x.dtype,
                                             device=x.device)])

        return _per_slot(state, grow)
    n = int(state.n_active())
    if n > new_capacity:
        raise ValueError(f"cannot shrink capacity to {new_capacity}: {n} active gaussians")
    idx = torch.sort((~state.active).to(torch.uint8), stable=True).indices[:new_capacity]
    return _per_slot(state, lambda x: x[idx])


def maybe_grow(state: GaussianState, headroom: float = 0.9) -> GaussianState:
    """Double the capacity on the host when occupancy reaches ``headroom``."""
    if int(state.n_active()) < headroom * state.capacity:
        return state
    return resize_capacity(state, 2 * state.capacity)


def get_tetra_points(state: GaussianState):
    """Tetrahedralization seeds (gaussian_model.py:399-429): the 8 oriented
    box corners at 3 sigma of the filtered scales, then the centres, over the
    active Gaussians. Returns host numpy (points (9n, 3) float32,
    point_scales (9n,) float32 = 3 x the largest filtered scale), corners
    first, as the reference orders them."""
    sel = state.active.nonzero()[:, 0]
    scales, _ = state.get_fused_scaling_opacity()

    def host(x):
        return x[sel].detach().cpu().numpy()

    xyz = host(state.params.xyz)
    R = host(quat_to_rotmat(state.get_rotation()))
    scale = host(scales) * 3.0
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float64)  # (8, 3), trimesh.creation.box() * 2 order
    pts = xyz[:, None, :] + np.einsum("nij,nkj->nki", R, corners[None] * scale[:, None, :])
    smax = scale.max(axis=-1)
    all_pts = np.concatenate([pts.reshape(-1, 3), xyz], axis=0)
    all_scales = np.concatenate([np.repeat(smax, 8), smax], axis=0)
    return all_pts.astype(np.float32), all_scales.astype(np.float32)


# ------------------------------------------------------------- PLY I/O ----


def save_gaussian_ply(path, state: GaussianState):
    """Reference-compatible PLY snapshot of the active Gaussians
    (gaussian_model.py:363-397), including the filter_3D attribute."""
    sel = state.active.nonzero()[:, 0]

    def host(x):
        return x[sel].detach().cpu().numpy()

    p = state.params
    n = int(sel.shape[0])
    xyz = host(p.xyz)
    f_dc = host(p.f_dc).transpose(0, 2, 1).reshape(n, -1)  # (n, 3)
    f_rest = host(p.f_rest).transpose(0, 2, 1).reshape(n, -1)
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
        + ["filter_3D"]
    )
    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, host(p.opacity), host(p.scaling),
         host(p.rotation), host(state.filter_3d)], axis=1
    ).astype(np.float32)
    arr = np.rec.fromarrays(cols.T, dtype=[(nm, "f4") for nm in names])
    plyio.write_ply(path, {"vertex": np.asarray(arr)})


def load_gaussian_ply(path, sh_degree: int = 3, capacity: int | None = None,
                      device=None) -> GaussianState:
    """Load a reference-format PLY (gaussian_model.py:515-559) onto ``device``
    (default ``cuda``) at ``capacity`` (default: the next power of two)."""
    dev = resolve_device(device)
    v = plyio.read_ply(path)["vertex"]
    n = len(v)
    names = v.dtype.names
    M = num_sh_coeffs(sh_degree)
    rest_names = sorted(
        (nm for nm in names if nm.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    if len(rest_names) != 3 * (M - 1):
        raise ValueError(f"SH count mismatch: {len(rest_names)} f_rest columns "
                         f"for sh_degree={sh_degree}")
    xyz = np.stack([v["x"], v["y"], v["z"]], 1)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], 1).reshape(n, 3, 1)
    f_rest = np.stack([v[nm] for nm in rest_names], 1).reshape(n, 3, M - 1)
    opac = np.asarray(v["opacity"])[:, None]
    scale = np.stack([v[f"scale_{i}"] for i in range(3)], 1)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)], 1)
    filt = (np.asarray(v["filter_3D"])[:, None] if "filter_3D" in names
            else np.zeros((n, 1)))

    if capacity is None:
        capacity = round_capacity(n)
    state = empty_state(capacity, sh_degree, device=dev)

    def put(dst, src):
        out = dst.clone()
        out[:n] = torch.as_tensor(np.asarray(src, np.float32), device=dev)
        return out

    params = GaussianParams(
        xyz=put(state.params.xyz, xyz),
        f_dc=put(state.params.f_dc, f_dc.transpose(0, 2, 1)),
        f_rest=put(state.params.f_rest, f_rest.transpose(0, 2, 1)),
        scaling=put(state.params.scaling, scale),
        rotation=put(state.params.rotation, rot),
        opacity=put(state.params.opacity, opac),
    )
    active = state.active.clone()
    active[:n] = True
    return state.replace(params=params, active=active,
                         filter_3d=put(state.filter_3d, filt),
                         active_sh_degree=sh_degree)
