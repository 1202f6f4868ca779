"""Run a function on several ranks, one spawned process each (the
counterpart of the JAX package's one controller over many devices).

``run_ranks(fn, world_size, ...)`` starts ``world_size`` processes with the
``spawn`` method, joins them in one process group over a ``file://`` store,
and calls ``fn(mesh, *args)`` on each (``fn`` must be importable: a
module-level function). It returns every rank's result with that rank's
kernel launch counts, or raises: a rank's exception (with its traceback),
a rank that dies, and a run that outlives ``timeout_s`` all end the call,
and every process it started is stopped. The process group's own timeout
is ``timeout_s`` too, so a rank left waiting in a collective fails instead
of hanging.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 1800.0  # the collectives' timeout when the run has no time limit


class RankOutput(NamedTuple):
    """What one rank returned, and the launches of every kernel in it."""

    result: Any
    launches: dict


def kernel_launches() -> dict:
    """This process's launch counts of every kernel of the port."""
    from radegs_torch.ops import bisect, blend, integrate

    return {**blend.LAUNCHES, **integrate.LAUNCHES, **bisect.LAUNCHES}


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``cpu``, or the card ``rank mod cards`` (all
    on card 0 of a one-card machine) unless ``device`` names one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def default_backend(world_size: int, device=None) -> str:
    """The backend when the caller names none: ``nccl`` when every rank has
    a card of its own (``device`` ``cuda`` with no more ranks than cards,
    or one rank on a named card), else ``gloo`` (the CPU, or ranks that
    share a card)."""
    dev = torch.device("cuda" if device is None else device)
    cards = 0 if dev.type != "cuda" else 1 if dev.index is not None else torch.cuda.device_count()
    return "nccl" if 0 < world_size <= cards else "gloo"


def _rank_main(fn, rank, world, backend, device, init, out_q, args, timeout_s):
    try:
        from radegs_torch.parallel.comm import make_mesh_1d

        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s or GROUP_TIMEOUT_S))
        result = fn(make_mesh_1d(device=dev), *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # pickled here by value: the queue's own pickler would pass tensors
        # as shared memory handles that die with this process
        out_q.put((rank, True, pickle.dumps(RankOutput(result, kernel_launches()))))
    except BaseException:  # reported to the caller, which stops every rank
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str | None = None, device=None,
              timeout_s: float | None = 600.0, args: tuple = ()) -> list[RankOutput]:
    """``fn(mesh, *args)`` on ranks 0..world_size-1; returns their
    ``RankOutput`` s in rank order. ``device``: ``cpu``, or ``cuda`` (default;
    rank r on card r mod cards) or one card for every rank. ``backend``:
    ``gloo`` or ``nccl`` (one card a rank: more ranks than cards raises);
    None: ``default_backend``. ``timeout_s``: the limit of the whole run and
    of each collective (None: no limit on the run)."""
    backend = backend or default_backend(world_size, device)
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL cannot run {world_size} ranks on "
                         f"{torch.cuda.device_count()} card(s): two ranks may not share a "
                         "card under NCCL; use the gloo backend")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="radegs_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, device, init,
                                                      out_q, args, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results = {}
        try:
            while len(results) < world_size:
                try:
                    rank, ok, payload = out_q.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) exited without a result: {dead} "
                                           "(rank, exit code)") from None
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(results))}"
                                           f" still running after {timeout_s} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
                results[rank] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world_size)]
