"""The port's multi-rank layer without JAX: the collectives of
``parallel/comm.py`` (forward and backward at world 2 and 3 against the
same sums written out by hand), the strided layout, shard / gather,
``run_ranks``' failures (a rank that raises, a rank that hangs, NCCL with
more ranks than cards) and its default backend, and the rank functions that the JAX comparisons
of test_torch_parallel_*.py spawn (this module imports no JAX, so the
spawned ranks do not either).

Ranks run as spawned processes with gloo on the CPU, each spawn with its
own time limit.
"""

import time

import numpy as np
import pytest
import torch

from radegs_torch.models import gaussian_model as tgm
from radegs_torch.parallel import (
    all_gather_rows,
    band_layout,
    default_backend,
    gather_gaussian_state,
    gather_train_state,
    halo,
    make_mesh,
    make_sharded_train_step,
    pad_gt,
    run_ranks,
    shard_gaussian_state,
    shard_train_state,
    strided_perm,
    to_canonical,
    to_strided,
)
from radegs_torch.parallel.comm import make_mesh_1d, psum, replicas_agree

torch.set_num_threads(1)
SPAWN_S = 120  # the time limit of one spawn of ranks
H_ROWS, WIDTH, HALO = 6, 5, 2


# ------------------------------------------------------- rank functions ----


def band(rank, seed):
    """Rank ``rank``'s (2, H_ROWS, WIDTH) band of a seeded image."""
    rng = np.random.default_rng(seed + rank)
    return torch.from_numpy(rng.normal(size=(2, H_ROWS, WIDTH)).astype(np.float32))


def rank_collectives(mesh):
    """Forward and backward of ``all_gather_rows`` and ``halo`` on seeded
    inputs with seeded cotangents; returns what a test compares by hand."""
    r = mesh.rank
    x = band(r, 0).requires_grad_(True)
    rows = x[0]  # (H_ROWS, WIDTH): the gathered rows
    g_rows = torch.from_numpy(np.random.default_rng(100 + r).normal(
        size=(mesh.world * H_ROWS, WIDTH)).astype(np.float32))
    top, bot = halo(x, HALO, mesh)
    g_top, g_bot = (torch.from_numpy(np.random.default_rng(s + r).normal(
        size=(2, HALO, WIDTH)).astype(np.float32)) for s in (200, 300))
    gathered = all_gather_rows(rows, mesh)
    loss = (gathered * g_rows).sum() + (top * g_top).sum() + (bot * g_bot).sum()
    loss.backward()
    total = psum(loss.detach().to(torch.float64), mesh)
    agree = replicas_agree(total, mesh), replicas_agree(torch.tensor([float(r)]), mesh)
    return gathered.detach().numpy(), top.detach().numpy(), bot.detach().numpy(), \
        x.grad.numpy(), float(total), agree


def rank_shard_roundtrip(mesh, cap):
    """shard -> gather of a seeded state, and a TrainState's, on every rank."""
    from radegs_torch.train.loop import init_train_state

    state = seeded_state(cap)
    local = shard_gaussian_state(to_strided(state, mesh.world), mesh)
    back = to_canonical(gather_gaussian_state(local, mesh), mesh.world)
    ts = gather_train_state(shard_train_state(init_train_state(state), mesh), mesh)
    return local.capacity, states_equal(back, state), states_equal(ts.gaussians, state)


def rank_raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits for the rank that failed


def rank_hangs(mesh):
    if mesh.rank == 1:
        time.sleep(600)  # never reaches the barrier
    torch.distributed.barrier()


def rank_step(mesh, arrays, cam_args, gt, cfg, app=None, vis_capacities=(None,)):
    """The multi-rank step from a state carried as host arrays (canonical
    layout), once per entry of ``vis_capacities``; each returns (metrics as
    floats, canonical state fields as numpy, appearance tensors as numpy)."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import TrainState

    n = mesh.world
    cam = Camera.look_at(*cam_args, device="cpu")
    gt = torch.from_numpy(gt)
    out = []
    for vis_cap in vis_capacities:
        state = tgm.state_from_arrays(**arrays, device="cpu")
        ts = shard_train_state(TrainState(gaussians=to_strided(state, n), **(app or {})), mesh)
        step = make_sharded_train_step(ModelConfig(**cfg[0]), OptimizationConfig(**cfg[1]),
                                       PipelineConfig(**cfg[2]), 3.5, mesh, cam.width,
                                       cam.height, vis_capacity=vis_cap)
        ts, m = step(ts, cam, pad_gt(gt, band_layout(cam.height, n)[2]), torch.zeros(3), 0)
        g = to_canonical(gather_gaussian_state(ts.gaussians, mesh), n)
        app_out = None if ts.app_params is None else {
            k: v.numpy() for k, v in list(ts.app_params["net"].items())
            + [("embeddings", ts.app_params["embeddings"])]}
        out.append(({k: float(v) for k, v in m.items()}, state_fields(g), app_out))
    return out


def rank_train(mesh, arrays, cam_args, gt, cfgs):
    """``train(mesh=)`` from a carried state, once per configuration in
    ``cfgs``; returns [(history, canonical state fields)]."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import SceneLike, train

    cam = Camera.look_at(*cam_args, device="cpu")
    out = []
    for cfg in cfgs:
        state = tgm.state_from_arrays(**arrays, device="cpu")
        ts, hist = train(SceneLike(cameras=[(cam, torch.from_numpy(gt), 0)], extent=3.5),
                         state, ModelConfig(**cfg[0]), OptimizationConfig(**cfg[1]),
                         PipelineConfig(**cfg[2]), log_every=1, mesh=mesh, device="cpu")
        out.append((hist, state_fields(ts.gaussians)))
    return out


# ------------------------------------------------------------- helpers ----


def seeded_state(cap, n_active=None, seed=0):
    rng = np.random.default_rng(seed)
    n_active = cap * 3 // 4 if n_active is None else n_active
    state = tgm.create_from_points(rng.normal(size=(n_active, 3)).astype(np.float32),
                                   rng.uniform(size=(n_active, 3)).astype(np.float32),
                                   capacity=cap, device="cpu")
    return state.replace(grad_accum=torch.from_numpy(rng.uniform(size=cap).astype(np.float32)),
                         denom=torch.from_numpy(rng.integers(0, 5, cap).astype(np.float32)))


def state_fields(g):
    """A state's per-slot tensors as numpy, by name."""
    out = {k: v.detach().numpy() for k, v in g.params.items()}
    out.update({f"m_{k}": v.numpy() for k, v in g.adam_m.items()})
    out.update({k: getattr(g, k).numpy() for k in tgm.TRAINING_FIELDS + ("active", "filter_3d")})
    return out


def states_equal(a, b):
    fa, fb = state_fields(a), state_fields(b)
    return all(np.array_equal(fa[k], fb[k]) for k in fa) and a.adam_step == b.adam_step


# --------------------------------------------------------------- tests ----


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_forward_and_backward(world):
    outs = [o.result for o in run_ranks(rank_collectives, world, "gloo", "cpu",
                                        timeout_s=SPAWN_S)]
    xs = [band(r, 0).numpy() for r in range(world)]
    g_rows = [np.random.default_rng(100 + r).normal(size=(world * H_ROWS, WIDTH)).astype(
        np.float32) for r in range(world)]
    g_top = [np.random.default_rng(200 + r).normal(size=(2, HALO, WIDTH)).astype(np.float32)
             for r in range(world)]
    g_bot = [np.random.default_rng(300 + r).normal(size=(2, HALO, WIDTH)).astype(np.float32)
             for r in range(world)]
    zeros = np.zeros((2, HALO, WIDTH), np.float32)
    want_total = 0.0
    for r, (gathered, top, bot, grad, total, agree) in enumerate(outs):
        assert np.array_equal(gathered, np.concatenate([x[0] for x in xs]))
        assert np.array_equal(top, xs[r - 1][:, -HALO:] if r > 0 else zeros)
        assert np.array_equal(bot, xs[r + 1][:, :HALO] if r < world - 1 else zeros)
        # d/dx of sum over ranks: my rows in every rank's gather, my last rows
        # in the next rank's top halo, my first rows in the previous one's bottom
        want = np.zeros_like(xs[r])
        want[0] = sum(g[r * H_ROWS:(r + 1) * H_ROWS] for g in g_rows)
        if r < world - 1:
            want[:, -HALO:] += g_top[r + 1]
        if r > 0:
            want[:, :HALO] += g_bot[r - 1]
        np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)
        want_total += float((gathered * g_rows[r]).sum() + (top * g_top[r]).sum()
                            + (bot * g_bot[r]).sum())
        assert agree == (True, False)
    assert all(abs(o[4] - want_total) <= 1e-4 * abs(want_total) for o in outs)


def test_strided_layout_roundtrip_and_balance():
    """tests/test_sharding.py:257-278 on the port: a bijection that spreads a
    front-packed active prefix evenly over the rank blocks."""
    rng = np.random.default_rng(0)
    P, cap, n = 100, 256, 8
    state = tgm.create_from_points(rng.normal(size=(P, 3)).astype(np.float32),
                                   rng.uniform(size=(P, 3)).astype(np.float32), capacity=cap,
                                   device="cpu")
    st = to_strided(state, n)
    blocks = st.active.reshape(n, cap // n).sum(1)
    assert int(blocks.max() - blocks.min()) <= 1, blocks
    assert int(state.active.reshape(n, cap // n).sum(1).max()) == cap // n
    assert states_equal(to_canonical(st, n), state)
    perm = strided_perm(cap, n)
    assert torch.equal(torch.sort(perm).values, torch.arange(cap))
    with pytest.raises(ValueError, match="multiple of the world size"):
        to_strided(state, 3)


def test_shard_gather_roundtrip():
    cap = 64
    outs = run_ranks(rank_shard_roundtrip, 2, "gloo", "cpu", timeout_s=SPAWN_S, args=(cap,))
    assert [o.result for o in outs] == [(cap // 2, True, True)] * 2


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(rank_raises, 2, "gloo", "cpu", timeout_s=SPAWN_S)


def test_a_hung_rank_times_out():
    """Rank 0 waits in a collective for rank 1, which never comes: the
    group's timeout or the run's ends the call, and both ranks are stopped."""
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        run_ranks(rank_hangs, 2, "gloo", "cpu", timeout_s=15)
    assert time.monotonic() - t0 < 90


def test_nccl_refuses_more_ranks_than_cards():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(rank_raises, cards + 1, "nccl", "cuda", timeout_s=SPAWN_S)


@pytest.mark.parametrize("world, device, cards, expected", [
    (1, "cuda", 4, "nccl"), (4, "cuda", 4, "nccl"), (5, "cuda", 4, "gloo"),
    (1, "cuda:0", 1, "nccl"), (2, "cuda:0", 4, "gloo"), (1, "cuda", 0, "gloo"),
    (2, "cpu", 4, "gloo"), (1, "cpu", 0, "gloo")])
def test_default_backend_is_nccl_only_with_a_card_per_rank(world, device, cards, expected,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend(world, device) == expected


def test_mesh_needs_a_group_and_one_tile_axis():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_1d(device="cpu")
    with pytest.raises(ValueError, match="tile_parallel"):
        make_mesh(tile_parallel=2, device="cpu")
