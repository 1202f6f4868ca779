"""The reference renderer and the roofline's pair counts: the blocked,
parallel walk against a direct sequential walk of every pixel, and the maps
against the program's own exact reference renderer (a test may import
both; the reference itself imports nothing of the program)."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import render as rr
from benchmark.reference import scene as rs


def small_scene(seed=0, n=60, W=40, H=24):
    g = torch.Generator().manual_seed(seed)
    params = rs.initial_params(torch.randn(n, 3, generator=g) * 0.6,
                               torch.rand(n, 3, generator=g), 1.0, 0.6)
    params["scaling"] = params["scaling"] + 0.5
    params["opacity"] = torch.randn(n, 1, generator=g)
    params["f_rest"] = torch.randn(params["f_rest"].shape, generator=g) * 0.2
    cam = rs.look_at([0.3, 0.2, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, W, H, "cpu")
    return params, rs.filter_3d(params["xyz"], [cam]), cam


def direct_counts(prep, W, H):
    """A sequential walk of every pixel over the depth-ordered splats whose
    3-sigma square covers its tile."""
    valid = prep["valid"].numpy()
    order = np.argsort(np.where(valid, prep["depth"].numpy(), np.inf), kind="stable")
    xy, r = prep["xy"].numpy(), prep["radius"].numpy()
    conic, op = prep["conic"].numpy(), prep["opacity"].numpy()
    n_alpha = n_incl = 0
    for py in range(H):
        for px in range(W):
            T = 1.0
            for i in order:
                if not valid[i]:
                    continue
                tx, ty = px // 16, py // 16
                if not (np.floor((xy[i, 0] - r[i]) / 16) <= tx < np.floor((xy[i, 0] + r[i]) / 16) + 1
                        and np.floor((xy[i, 1] - r[i]) / 16) <= ty
                        < np.floor((xy[i, 1] + r[i]) / 16) + 1):
                    continue
                dx, dy = xy[i, 0] - px, xy[i, 1] - py
                a, b, c = conic[i]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, op[i] * np.exp(power))
                if alpha < 1 / 255:
                    continue
                n_alpha += 1
                if T * (1 - alpha) < 1e-4:
                    break
                n_incl += 1
                T *= 1 - alpha
    return n_alpha, n_incl


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_equal_a_direct_walk(seed):
    params, f3, cam = small_scene(seed)
    prep = rr.preprocess(params, f3, cam, 0.1, 3)
    _, counts = rr.raw_maps(prep, cam.width, cam.height, count=True)
    assert (counts["n_alpha"], counts["n_incl"]) == direct_counts(prep, cam.width, cam.height)
    assert counts["n_incl"] > 0 and counts["n_alpha"] > counts["n_incl"]
    t_f, t_b = (roofline.least_fwd_s(counts, 40, 24), roofline.least_bwd_s(counts, 40, 24))
    assert 0 < t_f < t_b


def test_small_blocks_give_the_same_maps():
    params, f3, cam = small_scene(2)
    prep = rr.preprocess(params, f3, cam, 0.1, 3)
    ids, starts, counts = rr.tile_lists(prep, cam.width, cam.height)
    whole = rr.blocks(counts)
    tiny = rr.blocks(counts, budget=1)
    assert len(tiny) == int((counts > 0).sum()) > len(whole)
    a, _ = rr.raw_maps(prep, cam.width, cam.height)
    saved = rr.PAIR_BUDGET
    try:
        rr.PAIR_BUDGET = 1
        b, _ = rr.raw_maps(prep, cam.width, cam.height)
    finally:
        rr.PAIR_BUDGET = saved
    for k in a:
        torch.testing.assert_close(a[k], b[k])


def test_maps_equal_the_programs_exact_reference():
    from radegs_torch.core.camera import Camera
    from radegs_torch.core.projection import preprocess_gaussians
    from radegs_torch.ops.reference import render_reference

    params, f3, cam = small_scene(3)
    maps = rr.render(params, f3, cam, 0.1, 3)
    s, rot, op = rr.activated(params, f3)
    pcam = Camera.look_at([0.3, 0.2, -3.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 40, 24,
                          device="cpu")
    prep = preprocess_gaussians(params["xyz"], s, rot, op,
                                torch.cat([params["f_dc"], params["f_rest"]], 1), 3, pcam,
                                kernel_size=0.1)
    ref = render_reference(prep, 40, 24, pcam.focal_x, pcam.focal_y, torch.zeros(3))
    for k in ("render", "expected_depth", "median_depth", "normal"):
        torch.testing.assert_close(maps[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)
    torch.testing.assert_close(maps["mask"], ref["alpha"], rtol=1e-4, atol=1e-5)


def test_backward_blocks_equal_whole_autograd():
    """Gradients block by block (features as leaves, map gradients handed
    in) equal autograd through the whole render at once."""
    params, f3, cam = small_scene(4)
    prep = rr.preprocess(params, f3, cam, 0.1, 3)
    feats = {k: v.detach().requires_grad_(True) for k, v in rr.blend_features(prep).items()}
    prep2 = dict(prep, **feats)
    w = {k: torch.randn(v.shape[0], 256, v.shape[2], generator=torch.Generator().manual_seed(9))
         for k, v in rr.raw_maps(prep, 40, 24)[0].items()}
    ids, starts, counts = rr.tile_lists(prep, 40, 24)
    t_all = [t for tiles, _ in rr.blocks(counts) for t in tiles]
    total = 0.0
    for tiles, K in rr.blocks(counts):
        bid = rr.block_ids(ids, starts, counts, tiles, K)
        res = rr.blend_block(feats, bid, rr.tile_pixels(tiles, 40, "cpu"))
        t = torch.as_tensor(tiles)
        total = total + sum((res[k] * w[k][t]).sum() for k in res)
    total.backward()
    whole = {k: v.grad.clone() for k, v in feats.items()}
    leaf = {k: v.detach().requires_grad_(True) for k, v in prep2.items() if k in feats}
    rr.backward_blocks(leaf, (ids, starts, counts), w, 40)
    for k in feats:
        torch.testing.assert_close(leaf[k].grad, whole[k], msg=k)
    assert len(t_all) == len(set(t_all))


@pytest.mark.parametrize("generator,n", [("cloud", 6000), ("surface", 9000)])
def test_knn_is_exact(generator, n):
    """The reference's 3-NN equals a brute-force search over all pairs,
    also where two neighbours lie at exactly the same distance."""
    from benchmark import scene

    pts, _ = scene.points_and_colors({"points": {"generator": generator, "n": n}}, 2 ** 31 + 3)
    p = torch.as_tensor(pts)
    p[1] = p[0] + torch.tensor([0.25, 0.0, 0.0])
    p[2] = p[0] - torch.tensor([0.25, 0.0, 0.0])
    p[3] = p[0] + torch.tensor([0.0, 0.5, 0.0])
    d2 = sum((p[:, None, i] - p[None, :, i]) ** 2 for i in range(3))
    d2.fill_diagonal_(torch.inf)
    want = torch.topk(d2, 3, dim=1, largest=False).values.mean(-1)
    got = rs.mean_dist2_knn(p, block=512)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[0]) == float(want[0]) and bool(torch.isfinite(got).all())
