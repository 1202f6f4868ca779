"""The collectives of the multi-rank train step on ``torch.distributed``:
the counterpart of the ``jax.lax`` collectives inside the JAX package's
``shard_map`` (``radegs_tpu/parallel/step.py``).

The JAX step is one program over a device axis; here every rank is a
process of its own (SPMD), holding its block of the Gaussians and its band
of the image. Two ``torch.autograd.Function`` s carry the cross-rank terms of
the gradient, so the differentiated loss holds no sum over ranks:

- ``all_gather_rows``: every rank's rows, concatenated in rank order. Its
  backward sums the cotangent over ranks and keeps this rank's slice (the
  transpose of ``all_gather``).
- ``halo``: the previous rank's last ``h`` rows and the next rank's first
  ``h`` rows (zeros at the image's edges), the ``ppermute`` pair of
  ``_halo``. Its backward hands each halo's cotangent to the rank that owns
  those rows.

Both are built on ``all_gather`` alone (and ``all_reduce`` in the backward),
so gloo and NCCL run the same code. Under gloo the module stages CUDA
tensors through pinned host memory itself; NCCL takes them as they are.
``torch.distributed.nn.functional`` is not used: its ``all_gather``
backward needs ``all_to_all``, which gloo lacks.

NCCL does not let two ranks share a card, so several ranks on one card run
gloo (``make_mesh_1d`` refuses NCCL with more ranks than cards).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from radegs_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh1D:
    """One rank's view of a 1-D mesh: its process group (None: the default
    group), rank, world size, device and backend."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """CUDA tensors go through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh_1d(backend: str | None = None, device=None) -> Mesh1D:
    """This rank's mesh over every rank of the default process group
    (``init_process_group`` first). ``backend``: that of the default group
    (None), or another, for which a group over the same ranks is made.
    ``device``: default the current CUDA device (raises without a card);
    ``cpu`` needs gloo. NCCL with more ranks than visible cards raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_1d needs an initialised default process group "
                           "(torch.distributed.init_process_group, or parallel.run_ranks)")
    default = dist.get_backend()
    backend = backend or default
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"NCCL cannot run {world} ranks on {cards} card(s): two ranks "
                             "may not share a card under NCCL; use the gloo backend")
    group = None if backend == default else dist.new_group(backend=backend)
    return Mesh1D(group, dist.get_rank(), world, dev, backend)


def _host(x, mesh: Mesh1D):
    """``x`` where the backend takes it: a pinned host copy under staging."""
    if not mesh.staged:
        return x.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_gather(x, mesh: Mesh1D) -> list:
    """Every rank's ``x`` (one shape on every rank), in rank order, on
    ``x``'s device. Not differentiable."""
    if mesh.world == 1:
        return [x]
    h = _host(x, mesh)
    outs = [torch.empty_like(h) for _ in range(mesh.world)]
    dist.all_gather(outs, h, group=mesh.group)
    return [o.to(x.device) for o in outs] if mesh.staged else outs


def all_reduce(x, mesh: Mesh1D, op=dist.ReduceOp.SUM):
    """``x`` reduced over ranks (a new tensor). Not differentiable."""
    if mesh.world == 1:
        return x.clone()
    h = _host(x, mesh)
    if h is x:
        h = x.clone()
    dist.all_reduce(h, op=op, group=mesh.group)
    return h.to(x.device) if mesh.staged else h


@torch.no_grad()
def psum(x, mesh: Mesh1D):
    """Sum over ranks of a metric tensor (outside autograd)."""
    return all_reduce(x.detach(), mesh)


@torch.no_grad()
def pmax(x, mesh: Mesh1D):
    """Maximum over ranks of a metric tensor (outside autograd)."""
    return all_reduce(x.detach(), mesh, dist.ReduceOp.MAX)


@torch.no_grad()
def replicas_agree(x, mesh: Mesh1D) -> bool:
    """Whether every rank holds the same values of ``x`` (a small tensor,
    e.g. a checksum): one ``MAX`` reduction of (x, -x)."""
    v = x.detach().reshape(-1).to(torch.float64)
    r = pmax(torch.cat([v, -v]), mesh)
    n = v.numel()
    return bool(torch.equal(r[:n], v) and torch.equal(r[n:], -v))


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return torch.cat(all_gather(x, mesh))

    @staticmethod
    def backward(ctx, g):
        r, k = ctx.mesh.rank, ctx.rows
        return all_reduce(g.contiguous(), ctx.mesh)[r * k:(r + 1) * k], None


def all_gather_rows(x, mesh: Mesh1D):
    """Differentiable gather of dim 0 over ranks (every rank's ``x`` has the
    same shape): forward the rows of ranks 0..n-1 in order, backward this
    rank's slice of the cotangent summed over ranks."""
    return _AllGatherRows.apply(x, mesh)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, mesh):
        ctx.mesh, ctx.h, ctx.shape = mesh, h, x.shape
        r, n = mesh.rank, mesh.world
        edges = all_gather(torch.cat([x[..., :h, :], x[..., -h:, :]], dim=-2), mesh)
        zeros = torch.zeros_like(x[..., :h, :])
        top = edges[r - 1][..., h:, :] if r > 0 else zeros  # the previous rank's last rows
        bot = edges[r + 1][..., :h, :] if r < n - 1 else zeros  # the next rank's first rows
        return top.contiguous(), bot.contiguous()

    @staticmethod
    def backward(ctx, g_top, g_bot):
        mesh, h = ctx.mesh, ctx.h
        r, n = mesh.rank, mesh.world
        gs = all_gather(torch.cat([g_top, g_bot], dim=-2), mesh)
        gx = torch.zeros(ctx.shape, dtype=g_top.dtype, device=g_top.device)
        if r > 0:  # my first rows were the previous rank's bottom halo
            gx[..., :h, :] += gs[r - 1][..., h:, :]
        if r < n - 1:  # my last rows were the next rank's top halo
            gx[..., -h:, :] += gs[r + 1][..., :h, :]
        return gx, None, None


def halo(x, h: int, mesh: Mesh1D):
    """(top, bottom) halos of ``h`` rows along dim -2 of this rank's band
    ``x``: the previous rank's last rows and the next rank's first rows,
    zeros at the first and last rank (the zero 'same' padding of the
    single-rank filters). Differentiable."""
    return _Halo.apply(x, h, mesh)


def with_halo(x, h: int, mesh: Mesh1D):
    """``x`` with its ``h``-row halos above and below (dim -2)."""
    top, bot = halo(x, h, mesh)
    return torch.cat([top, x, bot], dim=-2)
