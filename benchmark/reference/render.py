"""The reference renderer: RaDe-GS's forward (preprocess, SH colour, the
Mip 2D/3D filters, ray-space depth planes and normals, front-to-back alpha
blending with the median depth), in plain PyTorch.

Preprocess follows ``preprocessCUDA`` / ``computeCov2D`` of the RaDe-GS
rasterizer (forward.cu:77-423). The blend evaluates every (pixel, splat)
pair of a 16 x 16 tile whose splat's 3-sigma square covers the tile, in depth
order, with the sequential rules of ``renderCUDA`` (forward.cu:550-611) in a
parallel form: power > 0 and alpha < 1/255 skip a pair, alpha is clipped at
0.99, the first pair whose T (1 - alpha) falls below 1e-4 ends the pixel and
is itself left out, and the median is the last blended pair with T > 0.5.
Tiles are processed in blocks whose padded pair count stays under a budget,
so a full 1600 x 1200 view of millions of splats fits; autograd through a
block gives the gradients, one block at a time (``backward_blocks``).

``dtype`` sets the precision of the per-pair arithmetic (the blend);
preprocess, normalisation and everything after stay float32.
"""

from __future__ import annotations

import torch

TILE = 16
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
NEAR_PLANE = 0.2
NORMALIZE_EPS = 1e-12

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)

# per-splat features the blend reads, and the raw per-pixel accumulators
FEATURES = ("xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
            "normal", "ts")
RAW = {"color": 3, "weight": 1, "dist": 1, "coord": 3, "normal": 3, "t_final": 1,
       "med_t": 1, "med_coord": 3}
PAIR_BUDGET = 1 << 25  # padded (pixel, splat) pairs per block


# ---- preprocess -------------------------------------------------------------


def _bmm3(A, B):
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _quad(u, M, v):
    return (u[:, :, None] * M * v[:, None, :]).sum((1, 2))


def _rotmat(q):
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
                     2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
                     2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
                    dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def sh_color(sh, means, campos, active_degree: int):
    """max(SH(dir) + 0.5, 0), coefficients above ``active_degree`` masked."""
    dirs = means - campos
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = torch.stack([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), SH_C3[4] * x * (4.0 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)], dim=-1)
    k = sh.shape[-2]
    basis = basis[..., :k] * (torch.arange(k, device=sh.device) < (active_degree + 1) ** 2)
    return torch.clamp_min((basis[..., None] * sh).sum(-2) + 0.5, 0.0)


def activated(params, filter3d):
    """(scales, rotations, opacity) with the Mip 3D filter fused in."""
    s2 = torch.square(torch.exp(params["scaling"]))
    s2f = s2 + torch.square(filter3d)
    coef = torch.sqrt(torch.prod(s2 / s2f, dim=-1))
    q = params["rotation"]
    rot = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.sqrt(s2f), rot, torch.sigmoid(params["opacity"]) * coef[:, None]


def preprocess(params, filter3d, cam, kernel_size: float, active_degree: int,
               xy_offset=None):
    """The per-splat blend features of one view (a dict over ``FEATURES``
    plus ``valid``, ``radius`` and ``depth``)."""
    scales, rotations, opac = activated(params, filter3d)
    means = params["xyz"]
    shs = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
    P = means.shape[0]
    opac = opac.reshape(P)
    W, H = cam.width, cam.height
    viewmat, full_proj = cam.world_view, cam.full_proj
    Rw2c, tvec = viewmat[:3, :3], viewmat[:3, 3]
    fx, fy = cam.focal_x, cam.focal_y

    p_view = means @ Rw2c.T + tvec
    in_front = p_view[:, 2] > NEAR_PLANE
    z = torch.where(in_front, p_view[:, 2], 1.0)
    p_hom = means @ full_proj[:, :3].T + full_proj[:, 3]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    xy = torch.stack([((p_proj[:, 0] + 1.0) * W - 1.0) * 0.5,
                      ((p_proj[:, 1] + 1.0) * H - 1.0) * 0.5], dim=-1)
    if xy_offset is not None:
        xy = xy + xy_offset

    R = _rotmat(rotations)
    s2 = torch.square(scales)
    Rt = R.transpose(1, 2)
    cov3d = _bmm3(R * s2[:, None, :], Rt)
    min_eig, arg = torch.min(s2, dim=-1)
    min_vec = torch.take_along_dim(R, arg[:, None, None].expand(P, 3, 1), dim=2)[..., 0]
    vrk_inv = torch.where((min_eig > 1e-8)[:, None, None],
                          _bmm3(R * (1.0 / torch.clamp_min(s2, 1e-30))[:, None, :], Rt),
                          min_vec[:, :, None] * min_vec[:, None, :])

    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    u = torch.clamp(p_view[:, 0] / z, -limx, limx)
    v = torch.clamp(p_view[:, 1] / z, -limy, limy)
    tx, ty = u * z, v * z
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    m0 = j00[:, None] * Rw2c[0] + j02[:, None] * Rw2c[2]
    m1 = j11[:, None] * Rw2c[1] + j12[:, None] * Rw2c[2]
    a0, b0, c0 = _quad(m0, cov3d, m0), _quad(m0, cov3d, m1), _quad(m1, cov3d, m1)
    det0 = torch.clamp_min(a0 * c0 - b0 * b0, 1e-6)
    a1, c1 = a0 + kernel_size, c0 + kernel_size
    det1m = torch.clamp_min(a1 * c1 - b0 * b0, 1e-6)
    coef = torch.sqrt(det0 / (det1m + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1m <= 1e-6), 0.0, coef)
    det = a1 * c1 - b0 * b0
    nonsingular = det != 0.0
    det_inv = 1.0 / torch.where(nonsingular, det, 1.0)
    conic = torch.stack([c1 * det_inv, -b0 * det_inv, a1 * det_inv], dim=-1)
    mid = 0.5 * (a1 + c1)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(torch.maximum(mid + disc, mid - disc),
                                                         0.0)))

    cam_inv = _bmm3(_bmm3(Rw2c, vrk_inv), Rw2c.T)
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
    l_c = torch.sqrt(tx * tx + ty * ty + z * z)
    inv_nlfx, inv_nlfy = 1.0 / (nl * fx), 1.0 / (nl * fy)
    cp = torch.stack([
        torch.stack([(-(v2 + 1.0) * z + plane0 * tx) * inv_nlfx,
                     (uv * z + plane1 * tx) * inv_nlfy], dim=-1),
        torch.stack([(uv * z + plane0 * ty) * inv_nlfx,
                     (-(u2 + 1.0) * z + plane1 * ty) * inv_nlfy], dim=-1),
        torch.stack([(tx + plane0 * z) * inv_nlfx, (ty + plane1 * z) * inv_nlfy], dim=-1),
    ], dim=-2)
    ray_plane = torch.stack([plane0 * l_c * inv_nlfx, plane1 * l_c * inv_nlfy], dim=-1)
    factor = l_c / nl
    cam_normal = torch.stack([
        -plane0 * factor * inv_z - tx / l_c,
        -plane1 * factor * inv_z - ty / l_c,
        (plane0 * tx + plane1 * ty) * factor * inv_z2 - z / l_c], dim=-1)
    n2 = torch.sum(cam_normal * cam_normal, dim=-1, keepdim=True)
    normal = cam_normal * (1.0 / torch.sqrt(torch.clamp_min(n2, 1e-30)))
    normal = torch.where(plane_ok[:, None], normal, 0.0)
    cp = torch.where(plane_ok[:, None, None], cp, 0.0)
    ray_plane = torch.where(plane_ok[:, None], ray_plane, 0.0)

    rgb = sh_color(shs, means, cam.camera_center, active_degree)
    valid = in_front & nonsingular & (radius > 0)
    return {
        "xy": xy, "conic": conic, "opacity": torch.where(valid, opac * coef, 0.0), "rgb": rgb,
        "view_point": p_view, "camera_plane": cp, "ray_plane": ray_plane, "normal": normal,
        "ts": torch.linalg.vector_norm(p_view, dim=-1),
        "valid": valid, "radius": torch.where(valid, radius, 0.0), "depth": p_view[:, 2],
    }


# ---- tiles and blocks -------------------------------------------------------


def tile_lists(prep, width: int, height: int):
    """Per tile, the splats whose 3-sigma square covers it, in depth order:
    (ids, starts, counts) with ``ids`` the splat of each (tile, splat) pair
    sorted by (tile, depth)."""
    tx_n, ty_n = -(-width // TILE), -(-height // TILE)
    xy, r = prep["xy"].detach(), prep["radius"]
    valid = prep["valid"]
    dev = xy.device
    P = xy.shape[0]

    def lo(c, n):
        return torch.clamp(torch.floor((c - r) / TILE), 0, n).to(torch.int64)

    def hi(c, n):
        return torch.clamp(torch.floor((c + r) / TILE) + 1, 0, n).to(torch.int64)

    x0, y0 = lo(xy[:, 0], tx_n), lo(xy[:, 1], ty_n)
    w = torch.clamp_min(hi(xy[:, 0], tx_n) - x0, 0)
    cnt = torch.where(valid, w * torch.clamp_min(hi(xy[:, 1], ty_n) - y0, 0), 0)
    order = torch.argsort(torch.where(valid, prep["depth"].detach(), torch.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=dev)
    splat = torch.repeat_interleave(torch.arange(P, device=dev), cnt)
    within = torch.arange(splat.numel(), device=dev) - (torch.cumsum(cnt, 0) - cnt)[splat]
    wg = torch.clamp_min(w, 1)[splat]
    tile = (y0[splat] + within // wg) * tx_n + x0[splat] + within % wg
    sort = torch.argsort(tile * P + rank[splat])
    ids = splat[sort]
    counts = torch.bincount(tile, minlength=tx_n * ty_n)
    starts = torch.cumsum(counts, 0) - counts
    return ids, starts, counts


def blocks(counts, budget: int = PAIR_BUDGET):
    """Tiles grouped into blocks of similar length, each block's padded
    pair count (tiles x longest list x 256) under ``budget`` where one tile
    allows: a list of (tile ids, longest list)."""
    order = torch.argsort(counts, descending=True).tolist()
    c = counts.tolist()
    out, cur = [], []
    for t in order:
        if c[t] == 0:
            break
        k = c[cur[0]] if cur else c[t]
        if cur and (len(cur) + 1) * k * TILE * TILE > budget:
            out.append((cur, k))
            cur = []
        cur.append(t)
    if cur:
        out.append((cur, c[cur[0]]))
    return out


def tile_pixels(tiles, width: int, device):
    """(n, 256, 2) integer pixel coordinates of the tiles, row-major inside."""
    tx_n = -(-width // TILE)
    t = torch.as_tensor(tiles, device=device)
    r = torch.arange(TILE * TILE, device=device)
    px = (t % tx_n)[:, None] * TILE + r % TILE
    py = (t // tx_n)[:, None] * TILE + r // TILE
    return torch.stack([px, py], dim=-1).to(torch.float32)


def block_ids(ids, starts, counts, tiles, K: int):
    """(n, K) splat ids of the tiles' lists, -1 past each list's end."""
    t = torch.as_tensor(tiles, device=ids.device)
    col = torch.arange(K, device=ids.device)
    ok = col[None] < counts[t][:, None]
    idx = torch.clamp(starts[t][:, None] + col[None], max=max(ids.numel() - 1, 0))
    return torch.where(ok, ids[idx], -1)


def blend_block(feat, bid, pix, dtype=torch.float32, abs_offset=None, count=None):
    """The blend of one block of tiles: ``feat`` per-splat features, ``bid``
    (n, K) ids, ``pix`` (n, 256, 2). Returns the raw accumulators (n, 256, c)
    in float32, and with ``count``, the image's (width, height), the pair
    counts of the pixels inside it (alpha >= 1/255 before the pixel ended;
    blended). ``abs_offset`` (n, K, 256, 2)
    is added to the centre in the alpha's falloff only: its gradient is each
    pair's screen-gradient through alpha."""
    real = bid >= 0
    g = {k: v[bid.clamp_min(0)].to(dtype) for k, v in feat.items()}
    pix = pix.to(dtype)
    d = g["xy"][:, :, None, :] - pix[:, None, :, :]  # (n, K, 256, 2)
    da = d if abs_offset is None else d + abs_offset.to(dtype)
    dx, dy = da[..., 0], da[..., 1]
    cn = g["conic"][:, :, None, :]
    power = -0.5 * (cn[..., 0] * dx * dx + cn[..., 2] * dy * dy) - cn[..., 1] * dx * dy
    alpha = torch.clamp_max(g["opacity"][:, :, None] * torch.exp(torch.clamp_max(power, 0.0)),
                            MAX_ALPHA)
    cand = (power <= 0.0) & (alpha >= ALPHA_EPS) & real[:, :, None]
    alpha = torch.where(cand, alpha, 0.0)

    one_minus = 1.0 - alpha
    t_prefix = torch.cumprod(one_minus, dim=1) / one_minus
    term = (alpha > 0.0) & (t_prefix * one_minus < T_EPS)
    ended = torch.cumsum(term.to(torch.int32), dim=1) > 0
    include = (alpha > 0.0) & ~ended
    w = torch.where(include, alpha * t_prefix, 0.0)
    t_final = torch.prod(torch.where(include, one_minus, 1.0), dim=1)

    t_ray = (g["ts"][:, :, None] + d[..., 0] * g["ray_plane"][:, :, None, 0]
             + d[..., 1] * g["ray_plane"][:, :, None, 1])
    cp = g["camera_plane"]
    coord_pt = (g["view_point"][:, :, None, :] + cp[:, :, None, :, 0] * d[..., 0:1]
                + cp[:, :, None, :, 1] * d[..., 1:2])  # (n, K, 256, 3)
    wk = w[..., None]
    K = bid.shape[1]
    med = torch.where(include & (t_prefix > 0.5),
                      torch.arange(K, device=bid.device)[None, :, None], -1).max(1).values
    has = med >= 0
    mi = med.clamp_min(0)[:, None, :]
    med_t = torch.where(has, torch.gather(t_ray, 1, mi)[:, 0], 0.0)
    med_coord = torch.where(has[..., None],
                            torch.gather(coord_pt, 1, mi[..., None].expand(-1, 1, -1, 3))[:, 0],
                            0.0)
    raw = {
        "color": (wk * g["rgb"][:, :, None, :]).sum(1),
        "weight": w.sum(1)[..., None],
        "dist": (w * t_ray).sum(1)[..., None],
        "coord": (wk * coord_pt).sum(1),
        "normal": (wk * g["normal"][:, :, None, :]).sum(1),
        "t_final": t_final[..., None],
        "med_t": med_t[..., None],
        "med_coord": med_coord,
    }
    raw = {k: v.to(torch.float32) for k, v in raw.items()}
    if count is None:
        return raw
    inside = ((pix[..., 0] < count[0]) & (pix[..., 1] < count[1]))[:, None, :]
    term_i = term.to(torch.int32)
    live = (alpha > 0.0) & ~((torch.cumsum(term_i, dim=1) - term_i) > 0)  # before the end
    return raw, {"n_alpha": int((live & inside).sum()), "n_incl": int((include & inside).sum())}


def blend_features(prep):
    return {k: prep[k] for k in FEATURES}


def raw_maps(prep, width: int, height: int, dtype=torch.float32, count=False):
    """All tiles' raw accumulators, (T, 256, c) each, without autograd;
    with ``count`` also the summed pair counts and the lists."""
    feat = {k: v.detach() for k, v in blend_features(prep).items()}
    ids, starts, counts = tile_lists(prep, width, height)
    T = counts.numel()
    dev = ids.device
    raw = {k: torch.zeros((T, TILE * TILE, c), dtype=torch.float32, device=dev)
           for k, c in RAW.items()}
    raw["t_final"].fill_(1.0)
    totals = {"n_alpha": 0, "n_incl": 0, "n_splats": int(torch.unique(ids).numel())}
    with torch.no_grad():
        for tiles, K in blocks(counts):
            bid = block_ids(ids, starts, counts, tiles, K)
            res = blend_block(feat, bid, tile_pixels(tiles, width, dev), dtype,
                              count=(width, height) if count else None)
            if count:
                res, n = res
                for k in n:
                    totals[k] += n[k]
            t = torch.as_tensor(tiles, device=dev)
            for k, v in res.items():
                raw[k][t] = v
    return (raw, totals) if count else (raw, (ids, starts, counts))


def backward_blocks(feat, lists, raw_grad, width: int, dtype=torch.float32,
                    ndc_half=None):
    """Autograd through the blend, block by block: each block is recomputed
    with ``feat`` (leaf tensors) in the graph and its raw outputs are given
    their slice of ``raw_grad``; the features' ``.grad`` accumulates. With
    ``ndc_half`` (W/2, H/2) it also returns the per-splat abs screen
    gradient sum_pixels |e_x| W/2 + |e_y| H/2 of the alpha's falloff."""
    ids, starts, counts = lists
    dev = ids.device
    P = feat["xy"].shape[0]
    abs_grad = torch.zeros((P,), dtype=torch.float32, device=dev)
    for tiles, K in blocks(counts):
        bid = block_ids(ids, starts, counts, tiles, K)
        off = None
        if ndc_half is not None:
            off = torch.zeros(bid.shape + (TILE * TILE, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        res = blend_block(feat, bid, tile_pixels(tiles, width, dev), dtype, abs_offset=off)
        t = torch.as_tensor(tiles, device=dev)
        keys = [k for k in res if raw_grad.get(k) is not None]
        torch.autograd.backward([res[k] for k in keys], [raw_grad[k][t] for k in keys])
        if off is not None:
            e = off.grad
            per = (e[..., 0].abs() * ndc_half[0] + e[..., 1].abs() * ndc_half[1]).sum(-1)
            real = bid >= 0
            abs_grad.index_add_(0, bid[real], per[real])
    return abs_grad


def normalize(raw, cam):
    """Raw accumulators (T, 256, c) -> the output maps (c, H, W): colour on
    a black background, alpha, expected and median depth, expected and
    median coordinates, the unit normal."""
    W, H = cam.width, cam.height
    tx_n, ty_n = -(-W // TILE), -(-H // TILE)
    dev = raw["weight"].device
    r = torch.arange(TILE * TILE, device=dev)
    t = torch.arange(tx_n * ty_n, device=dev)
    px = ((t % tx_n)[:, None] * TILE + r % TILE).to(torch.float32)
    py = ((t // tx_n)[:, None] * TILE + r // TILE).to(torch.float32)
    ln = torch.sqrt(((px - W / 2.0) / cam.focal_x) ** 2 + ((py - H / 2.0) / cam.focal_y) ** 2
                    + 1.0)[..., None]
    weight = raw["weight"]
    anyc = weight > 0.0
    inv_w = torch.where(anyc, 1.0 / torch.where(anyc, weight, 1.0), 0.0)
    n2 = torch.sum(torch.square(raw["normal"]), dim=-1, keepdim=True)
    n_len = torch.sqrt(torch.where(anyc, n2, 1.0))
    maps = {
        "render": raw["color"],
        "mask": weight,
        "expected_depth": raw["dist"] / ln * inv_w,
        "median_depth": raw["med_t"] / ln,
        "expected_coord": raw["coord"] * inv_w,
        "median_coord": raw["med_coord"],
        "normal": torch.where(anyc, raw["normal"] / torch.clamp_min(n_len, NORMALIZE_EPS), 0.0),
    }

    def image(x):
        c = x.shape[-1]
        img = x.reshape(ty_n, tx_n, TILE, TILE, c).permute(4, 0, 2, 1, 3)
        return img.reshape(c, ty_n * TILE, tx_n * TILE)[:, :H, :W]

    return {k: image(v) for k, v in maps.items()}


def render(params, filter3d, cam, kernel_size: float, active_degree: int,
           dtype=torch.float32, count=False):
    """The output maps of one view, without autograd; with ``count`` also
    the pair counts and the number of splats that reach a tile
    (``raw_maps``)."""
    with torch.no_grad():
        prep = preprocess(params, filter3d, cam, kernel_size, active_degree)
        raw, extra = raw_maps(prep, cam.width, cam.height, dtype, count=count)
        maps = normalize(raw, cam)
    return (maps, extra) if count else maps
