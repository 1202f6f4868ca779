"""Per-Gaussian preprocessing (port of ``radegs_tpu/core/projection.py``,
reference ``preprocessCUDA`` forward.cu:307-423 and ``computeCov2D``
forward.cu:77-264): projection, EWA 2D covariance with the Mip-Splatting 2D
filter, and RaDe-GS's ray-space plane / normal derivation.

- view transform & frustum cull (auxiliary.h:155-180): keep z_view > 0.2.
- EWA (forward.cu:85-124): cov2D = J W Sigma W^T J^T with J evaluated at the
  cone-clamped view point, then ``kernel_size`` on the diagonal with opacity
  compensation coef = sqrt(det0/det1).
- Ray-space planes (forward.cu:135-262): with Sigma_cam^-1 = W Sigma^-1 W^T
  and the clamped normalised image coords (u, v),
      t(pixel)     = t_c + ray_plane . dpix
      coord(pixel) = view_point + camera_plane @ dpix
  and the normal is the normalised image of (-p*l/nl, -1) under the inverse
  ray Jacobian.

Layouts are (P, k) and (P, 3, 3): the JAX package's component form exists
only to dodge TPU lane padding.

The per-Gaussian table is the one interface from the preprocess to the
blend: a (P, N_FEAT) float row per Gaussian in the column order of
``COLUMNS`` (the blend kernels' feature row, the FEAT_LAYOUT of
``radegs_tpu/ops/pallas_blend.py``), opacity 0 on a row that is not valid.
This module owns that layout; ``csrc/preprocess_fwd.cu`` writes it, the
blend kernels and ``csrc/preprocess_bwd.cu`` read it (and the blend's
gradient comes back in it) at the same column positions.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from radegs_torch.core.eigen import sym3x3_eigendecomposition, sym3x3_inverse
from radegs_torch.core.gaussians import (
    cov3d_to_sym6,
    quat_to_rotmat_raw,
    sym6_inverse,
    sym6_to_cov3d,
)
from radegs_torch.core.sh import eval_sh_color

NEAR_PLANE = 0.2  # auxiliary.h:21
EIG_EPS = 1e-8  # forward.cu:142 well-conditioned threshold

# the table's columns; camera_plane's two columns are [:, :, 0] at 15:18 and
# [:, :, 1] at 18:21
COLUMNS = {"xy": slice(0, 2), "conic": slice(2, 5), "opacity": 5, "rgb": slice(6, 9),
           "ts": 9, "ray_plane": slice(10, 12), "view_point": slice(12, 15),
           "camera_plane": slice(15, 21), "normal": slice(21, 24)}
DEPTH = 14  # view_point's z, the sort key
N_FEAT = 24


def column(table, name: str):
    """The view of field ``name`` (or ``depth``) in ``table``: (P,) or
    (P, k), camera_plane (P, 3, 2)."""
    if name == "depth":
        return table[:, DEPTH]
    v = table[:, COLUMNS[name]]
    return v.unflatten(1, (2, 3)).transpose(1, 2) if name == "camera_plane" else v


def pack_table(xy, conic, opacity, rgb, ts, ray_plane, view_point, camera_plane, normal):
    """The fields, (P, k) or (P,) and camera_plane (P, 3, 2), as one (P,
    N_FEAT) table in ``COLUMNS`` order and their dtype."""
    return torch.cat([xy, conic, opacity.reshape(-1, 1), rgb, ts.reshape(-1, 1), ray_plane,
                      view_point, camera_plane[:, :, 0], camera_plane[:, :, 1], normal], dim=1)


class _Column:
    """A float field of ``PreprocessOut``: read-only, its view of the table."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, prep, owner=None):
        return self if prep is None else column(prep.table, self.name)


@dataclass(frozen=True)
class PreprocessOut:
    """Per-Gaussian rasterization state (rasterizer_impl.cu:190-210): the
    table and what is not a float of it. The float fields are views of the
    table, so none can be replaced apart from it."""

    table: torch.Tensor  # (P, N_FEAT) in COLUMNS order, opacity 0 where not valid
    valid: torch.Tensor  # (P,)   bool — survives culling and has nonzero extent
    radius: torch.Tensor  # (P,)   screen-space radius (0 when culled)
    well_conditioned: torch.Tensor  # (P,) bool — Sigma invertible
    invraycov: torch.Tensor | None = None  # (P,3,3) inverse ray-space covariance

    xy = _Column()  # (P,2)  projected centre, pixel coords
    depth = _Column()  # (P,)   view-space z (sort key)
    view_point = _Column()  # (P,3)  view-space centre
    conic = _Column()  # (P,3)  inverse filtered 2D covariance (a, b, c)
    opacity = _Column()  # (P,)   opacity * mip coefficient
    rgb = _Column()  # (P,3)  SH-evaluated colour
    camera_plane = _Column()  # (P,3,2)
    ray_plane = _Column()  # (P,2)
    normal = _Column()  # (P,3)  view-space unit normal
    ts = _Column()  # (P,)   ray-space distance of the centre

    @classmethod
    def from_fields(cls, valid, radius, well_conditioned, *, xy, conic, opacity, rgb, ts,
                    ray_plane, view_point, camera_plane, normal,
                    invraycov=None) -> "PreprocessOut":
        """The fields packed into a table (``pack_table``), opacity zeroed
        where a row is not valid."""
        opacity = torch.where(valid, opacity.reshape(-1), 0.0)
        table = pack_table(xy=xy, conic=conic, opacity=opacity, rgb=rgb, ts=ts,
                           ray_plane=ray_plane, view_point=view_point,
                           camera_plane=camera_plane, normal=normal)
        return cls(table, valid, radius, well_conditioned, invraycov)

    def replace(self, **kw) -> "PreprocessOut":
        return replace(self, **kw)


def ndc2pix(v, size):
    """auxiliary.h:55-58."""
    return ((v + 1.0) * size - 1.0) * 0.5


# The (P,3,3) products below are written as broadcast multiply + sum: as
# batched GEMMs, cuBLAS runs 3x3 matrices at a few percent of the card
# (they were most of the preprocess time on the H100, PERF.md).


def _bmm3(A, B):
    """Batched 3x3 product A @ B, (P,3,3) or broadcastable (3,3)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _quad(u, M, v):
    """u^T M v per row: u, v (P,3), M (P,3,3) -> (P,)."""
    return (u[:, :, None] * M * v[:, None, :]).sum((1, 2))


def preprocess_gaussians(
    means3d,
    scales,
    rotations,
    opacities,
    shs,
    sh_degree: int,
    camera,
    kernel_size: float = 0.0,
    scale_modifier: float = 1.0,
    colors_precomp=None,
    cov3d_precomp=None,
    active_sh_degree: int | None = None,
    compute_invraycov: bool = False,
) -> PreprocessOut:
    """Vectorised preprocess over P Gaussians (forward.cu:307-423).

    means3d (P,3); scales (P,3) positive, already fused with the 3D filter;
    rotations (P,4) unit quaternions (w,x,y,z); opacities (P,1) or (P,),
    already mip-compensated; shs (P,M,3) with M >= (sh_degree+1)^2, or None
    with ``colors_precomp`` (P,3); ``cov3d_precomp`` (P,3,3) overrides
    scales/rotations. Float64 centres (and a float64 camera) are evaluated
    in float64, the tests' measure of truth for the gradient; anything else
    in float32."""
    dt = torch.float64 if means3d.dtype == torch.float64 else torch.float32
    means3d = means3d.to(dt)
    P = means3d.shape[0]
    opac = opacities.reshape(P).to(dt)

    W_img, H_img = camera.width, camera.height
    viewmat = camera.world_view
    full_proj = camera.full_proj
    Rw2c = viewmat[:3, :3]
    tvec = viewmat[:3, 3]
    fx, fy = camera.focal_x, camera.focal_y

    # --- view transform + frustum cull (auxiliary.h:155-180) ---
    p_view = means3d @ Rw2c.T + tvec
    in_front = p_view[:, 2] > NEAR_PLANE
    z = torch.where(in_front, p_view[:, 2], 1.0)  # safe z for the culled rows

    # --- NDC projection (forward.cu:355-358) ---
    p_hom = means3d @ full_proj[:, :3].T + full_proj[:, 3]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    xy = torch.stack([ndc2pix(p_proj[:, 0], W_img), ndc2pix(p_proj[:, 1], H_img)], dim=-1)

    # --- world covariance and its inverse ---
    if cov3d_precomp is not None:
        cov3d = cov3d_precomp.to(dt)
        eigval, eigvec, _ = sym3x3_eigendecomposition(cov3d)
        min_eig = eigval[:, 0]
        min_vec = eigvec[:, :, 0]
        vrk_inv_full = sym3x3_inverse(cov3d)
    else:
        R = quat_to_rotmat_raw(rotations.to(dt))
        s2 = torch.square(scales.to(dt) * scale_modifier)
        Rt = R.transpose(1, 2)
        cov3d = _bmm3(R * s2[:, None, :], Rt)
        min_eig, arg = torch.min(s2, dim=-1)  # first minimum on ties
        # smallest principal axis = R column at argmin(s^2) (forward.cu:151)
        min_vec = torch.take_along_dim(R, arg[:, None, None].expand(P, 3, 1), dim=2)[..., 0]
        vrk_inv_full = _bmm3(R * (1.0 / torch.clamp_min(s2, 1e-30))[:, None, :], Rt)

    well = min_eig > EIG_EPS  # forward.cu:142
    # ill-conditioned: project onto the smallest axis (forward.cu:151-155)
    vrk_inv = torch.where(well[:, None, None], vrk_inv_full,
                          min_vec[:, :, None] * min_vec[:, None, :])

    # --- EWA cov2D with cone clamp (forward.cu:85-124) ---
    limx, limy = 1.3 * camera.tanfovx, 1.3 * camera.tanfovy
    u = torch.clamp(p_view[:, 0] / z, -limx, limx)
    v = torch.clamp(p_view[:, 1] / z, -limy, limy)
    tx, ty = u * z, v * z

    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    # rows of M = J @ Rw2c
    m_row0 = j00[:, None] * Rw2c[0] + j02[:, None] * Rw2c[2]
    m_row1 = j11[:, None] * Rw2c[1] + j12[:, None] * Rw2c[2]
    a0 = _quad(m_row0, cov3d, m_row0)
    b0 = _quad(m_row0, cov3d, m_row1)
    c0 = _quad(m_row1, cov3d, m_row1)
    det0 = torch.clamp_min(a0 * c0 - b0 * b0, 1e-6)
    a1, c1 = a0 + kernel_size, c0 + kernel_size
    det1m = torch.clamp_min(a1 * c1 - b0 * b0, 1e-6)
    coef = torch.sqrt(det0 / (det1m + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1m <= 1e-6), 0.0, coef)  # forward.cu:122-124

    det = a1 * c1 - b0 * b0
    nonsingular = det != 0.0  # forward.cu:385-387
    det_inv = 1.0 / torch.where(nonsingular, det, 1.0)
    conic = torch.stack([c1 * det_inv, -b0 * det_inv, a1 * det_inv], dim=-1)

    # --- screen-space radius (forward.cu:391-398) ---
    mid = 0.5 * (a1 + c1)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = torch.maximum(mid + disc, mid - disc)
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    # --- ray-space planes & normal (forward.cu:135-262) ---
    cam_inv = _bmm3(_bmm3(Rw2c, vrk_inv), Rw2c.T)  # (P,3,3)
    uvh = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    m = (cam_inv * uvh[:, None, :]).sum(-1)
    mn2 = torch.sum(m * m, dim=-1)
    mn_norm = torch.sqrt(mn2)
    uvh_mn = m * (1.0 / torch.sqrt(torch.clamp_min(mn2, 1e-30)))[:, None]
    plane_ok = (mn_norm > 1e-20) & torch.isfinite(mn_norm)

    vbn = torch.sum(uvh_mn * uvh, dim=-1)
    mvec = uvh_mn * (1.0 / torch.clamp_min(vbn, 1e-7))[:, None]
    u2, v2, uv = u * u, v * v, u * v
    plane0 = (v2 + 1.0) * mvec[:, 0] - uv * mvec[:, 1] - u * mvec[:, 2]
    plane1 = -uv * mvec[:, 0] + (u2 + 1.0) * mvec[:, 1] - v * mvec[:, 2]

    nl = u2 + v2 + 1.0
    l_clamped = torch.sqrt(tx * tx + ty * ty + z * z)
    inv_nlfx = 1.0 / (nl * fx)
    inv_nlfy = 1.0 / (nl * fy)
    cp = torch.stack(
        [
            torch.stack([(-(v2 + 1.0) * z + plane0 * tx) * inv_nlfx,
                         (uv * z + plane1 * tx) * inv_nlfy], dim=-1),
            torch.stack([(uv * z + plane0 * ty) * inv_nlfx,
                         (-(u2 + 1.0) * z + plane1 * ty) * inv_nlfy], dim=-1),
            torch.stack([(tx + plane0 * z) * inv_nlfx,
                         (ty + plane1 * z) * inv_nlfy], dim=-1),
        ],
        dim=-2,
    )  # (P,3,2)
    ray_plane = torch.stack([plane0 * l_clamped * inv_nlfx,
                             plane1 * l_clamped * inv_nlfy], dim=-1)

    factor = l_clamped / nl
    cam_normal = torch.stack(
        [
            -plane0 * factor * inv_z - tx / l_clamped,
            -plane1 * factor * inv_z - ty / l_clamped,
            (plane0 * tx + plane1 * ty) * factor * inv_z2 - z / l_clamped,
        ],
        dim=-1,
    )
    n2 = torch.sum(cam_normal * cam_normal, dim=-1, keepdim=True)
    normal = cam_normal * (1.0 / torch.sqrt(torch.clamp_min(n2, 1e-30)))

    normal = torch.where(plane_ok[:, None], normal, 0.0)
    cp = torch.where(plane_ok[:, None, None], cp, 0.0)
    ray_plane = torch.where(plane_ok[:, None], ray_plane, 0.0)

    # --- colour ---
    if colors_precomp is not None:
        rgb = colors_precomp.to(dt)
    else:
        rgb, _ = eval_sh_color(sh_degree, shs.to(dt), means3d, camera.camera_center,
                               active_degree=active_sh_degree)

    ts = torch.linalg.vector_norm(p_view, dim=-1)  # forward.cu:381

    # --- inverse ray-space covariance for the integrate path (the INTE
    # branch of computeCov2D, forward.cu:187-235): (J_r Sigma_view J_r^T)^-1
    # at the cone-clamped centre, eigenvalue-regularised where Sigma is
    # ill-conditioned ---
    invraycov = None
    if compute_invraycov:
        zero = torch.zeros_like(z)
        Jr = torch.stack([
            torch.stack([j00, zero, j02], -1),
            torch.stack([zero, j11, j12], -1),
            torch.stack([tx / l_clamped, ty / l_clamped, z / l_clamped], -1),
        ], dim=-2)  # (P,3,3)
        v_view = _bmm3(_bmm3(Rw2c, cov3d), Rw2c.T)
        ray_cov = _bmm3(_bmm3(Jr, v_view), Jr.transpose(1, 2))
        reg = torch.where(well, 0.0, 1e-6)
        ray6 = cov3d_to_sym6(ray_cov)
        ray6 = ray6 + reg[:, None] * torch.tensor([1.0, 0, 0, 1.0, 0, 1.0],
                                                  device=ray6.device)
        invraycov = sym6_to_cov3d(sym6_inverse(ray6))

    valid = in_front & nonsingular & (radius > 0)
    radius = torch.where(valid, radius, 0.0)

    return PreprocessOut.from_fields(valid, radius, well, xy=xy, conic=conic,
                                     opacity=opac * coef, rgb=rgb, ts=ts, ray_plane=ray_plane,
                                     view_point=p_view, camera_plane=cp, normal=normal,
                                     invraycov=invraycov)
