"""Multi-rank training on ``torch.distributed`` (port of
``radegs_tpu/parallel/``): one process per rank, each holding its block of
the Gaussians and rendering its band of the image."""

from radegs_torch.parallel.comm import (
    Mesh1D,
    all_gather_rows,
    halo,
    make_mesh_1d,
    pmax,
    psum,
    with_halo,
)
from radegs_torch.parallel.launch import RankOutput, default_backend, run_ranks
from radegs_torch.parallel.rebalance import inverse_perm, strided_perm, to_canonical, to_strided
from radegs_torch.parallel.sharding import (
    gather_gaussian_state,
    gather_train_state,
    make_mesh,
    shard_gaussian_state,
    shard_train_state,
)
from radegs_torch.parallel.step import band_layout, make_sharded_train_step, pad_gt

__all__ = [
    "Mesh1D", "make_mesh_1d", "make_mesh", "all_gather_rows", "halo", "with_halo", "psum",
    "pmax", "run_ranks", "RankOutput", "default_backend", "strided_perm", "inverse_perm", "to_strided",
    "to_canonical", "shard_gaussian_state", "gather_gaussian_state", "shard_train_state",
    "gather_train_state", "band_layout", "pad_gt", "make_sharded_train_step",
]
