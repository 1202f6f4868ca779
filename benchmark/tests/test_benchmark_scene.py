"""The inputs: the copied generators draw as the program's bench does."""

import numpy as np
import torch

from benchmark import scene


def test_surface_points_equal_the_programs():
    from radegs_torch.scripts.synthetic import surface_points

    a = scene.surface_points(5000, np.random.default_rng(7))
    b = surface_points(5000, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)


def test_points_and_colors_follow_build_scene_draws():
    """``build_scene("100k")`` draws the points, then the colours, from one
    ``default_rng(seed)``; the copy does the same."""
    cfg = {"points": {"generator": "cloud", "n": 1000}}
    pts, cols = scene.points_and_colors(cfg, 11)
    rng = np.random.default_rng(11)
    np.testing.assert_array_equal(pts, (rng.normal(size=(1000, 3)) * 1.2).astype(np.float32))
    np.testing.assert_array_equal(cols, rng.uniform(0.1, 0.9, size=(1000, 3)).astype(np.float32))


def test_loaded_state_holds_the_benchmarks_arrays():
    """The serve cells' scene: the benchmark's arrays in the first rows of
    the program's state, the rest empty, the 3D filter the program's."""
    from radegs_torch.models import gaussian_model as gm

    from benchmark import jobs, program

    cfg = {"points": {"generator": "surface", "n": 3000}, "capacity": 4096,
           "scale_shrink": 1.0, "opacity": 0.8, "active_sh_degree": 3, "views": 3,
           "width": 48, "height": 32,
           "orbit": {"radius": 5.0, "elev": 0.8, "wave": 0.4, "fovx": 0.9, "fovy": 0.7}}
    pts, cols = scene.points_and_colors(cfg, 2 ** 31 + 9)
    params = jobs.scene_params(cfg, pts, cols, "cpu")
    cams = program.cameras(scene.view_eyes(cfg), cfg, "cpu")
    state = program.load_state(cfg, params, cams, "cpu")
    assert state.capacity == 4096 and int(state.active.sum()) == 3000
    assert state.active_sh_degree == 3 and bool(state.active[:3000].all())
    for k, v in state.params.items():
        torch.testing.assert_close(v[:3000], params[k], rtol=0, atol=0, msg=k)
    empty = gm.empty_state(4096, 3, device="cpu").params
    for k, v in state.params.items():
        torch.testing.assert_close(v[3000:], getattr(empty, k)[3000:], rtol=0, atol=0, msg=k)
    want = gm.update_3d_filter(state.replace(filter_3d=torch.zeros_like(state.filter_3d)), cams)
    torch.testing.assert_close(state.filter_3d, want.filter_3d, rtol=0, atol=0)


def test_views_pop_seeded_permutations():
    seq = scene.first_views(7, 21, 5)
    for i in range(3):
        assert sorted(seq[7 * i:7 * i + 7]) == list(range(7))
    rng = np.random.default_rng([5, 1])
    assert seq[:7] == list(reversed(rng.permutation(7).tolist()))
    assert seq == scene.first_views(7, 21, 5)


def test_large_seed_and_orbit():
    big = 2 ** 31 + 12345
    g1 = scene.ground_truth({"views": 2, "height": 4, "width": 5}, big, "cpu")
    g2 = scene.ground_truth({"views": 2, "height": 4, "width": 5}, big, "cpu")
    assert torch.equal(g1, g2) and float(g1.min()) >= 0 and float(g1.max()) < 1
    eyes = scene.orbit_eyes(49, 5.0, 0.8, 0.4)
    np.testing.assert_allclose(eyes[0], [0.0, 0.8, -5.0], atol=1e-12)
    serve = scene.orbit_eyes(240, 5.0, 0.8, 0.4, 0.5)
    assert min(np.linalg.norm(np.subtract(a, b)) for a in eyes for b in serve) > 1e-3
