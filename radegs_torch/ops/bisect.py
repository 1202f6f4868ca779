"""The bisect probes (port of ``scripts/_kernel_bisect.py``'s four Pallas
kernels, D): on CUDA tensors each wrapper launches its kernel in
``csrc/bisect_probes.cu`` (or raises), on CPU tensors it runs its plain
PyTorch version.

Every probe takes the JAX script's operands — ``start`` / ``count`` (T,)
int32 per grid step and ``feat`` (25, B) float32 — and returns (T, 8, 256)
float32:

- ``aligned``: the sum of ``feat[:, 0:128]``, broadcast;
- ``window``: the sum over the whole 128-column windows that cover
  ``[start, start + count)`` from ``start // 128 * 128`` (none when
  ``count == 0``), broadcast; NaN for a step whose start is negative or
  whose windows pass the last column;
- ``mm_highest``: rows 0..7 of ``f[0:19] @ w``, ``w[c, j] = f[0, c]``, with
  ``f = feat[:, 0:128]``, in full FP32;
- ``tri_mm``: rows 0..7 of ``tri @ x``, ``tri[r, c] = (r >= c)``,
  ``x[c, j] = f[0, c]``.

The kernels read whole 128-column rows in 16-byte units (``window`` with
tensor-map copies, the others with plain loads), which needs B to be a
multiple of 128 (every wrapper checks it; ``pad_columns`` pads a matrix
with zero columns).
The ``window`` kernel checks each step's windows against the matrix on the
card, so its wrapper never waits for it.
A wrapper call resolves the C entry once and switches device only for
tensors off the current one: the host call costs more than these kernels.
"""

from __future__ import annotations

import functools

import torch

from radegs_torch.native import build
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device

CH = 128
ROWS = 25
OUT_SHAPE = (8, 256)
PROBES = ("aligned", "window", "mm_highest", "tri_mm")
# kernel launches, counted by the wrappers where they launch a kernel and
# nowhere else (the tracer's group "launches.bisect")
LAUNCHES = trace.counters("launches.bisect", [f"bisect_{p}" for p in PROBES])


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pad_columns(feat, multiple: int = CH):
    """``feat`` with zero columns appended up to a multiple of ``multiple``."""
    pad = (-feat.shape[1]) % multiple
    return feat if pad == 0 else torch.nn.functional.pad(feat, (0, pad))


def window_bounds(start, count):
    """Per step: the first column of the aligned windows and their number."""
    start_al = start.to(torch.int64) // CH * CH
    n = torch.where(count > 0, (start - start_al + count + CH - 1) // CH, 0)
    return start_al, n


# ------------------------------------------------------- plain versions ----


def _broadcast(values):
    return values.to(torch.float32)[:, None, None].expand(-1, *OUT_SHAPE).contiguous()


def aligned_torch(start, count, feat):
    return _broadcast(feat[:, :CH].sum().expand(start.shape[0]))


def window_torch(start, count, feat):
    start_al, n = window_bounds(start, count)
    outside = (start < 0) | (start_al + n * CH > feat.shape[1])
    sums = [feat.new_tensor(float("nan")) if o else feat[:, a:a + CH * k].sum()
            for a, k, o in zip(start_al.tolist(), n.tolist(), outside.tolist())]
    return _broadcast(torch.stack(sums) if sums else feat.new_zeros(0))


def mm_highest_torch(start, count, feat):
    f = feat[:, :CH]
    w = f[0][:, None].expand(CH, OUT_SHAPE[1])
    R = torch.matmul(f[:19], w)
    return R[None, :OUT_SHAPE[0]].expand(start.shape[0], *OUT_SHAPE).contiguous()


def tri_mm_torch(start, count, feat):
    r = torch.arange(CH, device=feat.device)
    tri = (r[:, None] >= r[None, :]).to(torch.float32)
    x = feat[0, :CH][:, None].expand(CH, OUT_SHAPE[1])
    R = torch.matmul(tri, x)
    return R[None, :OUT_SHAPE[0]].expand(start.shape[0], *OUT_SHAPE).contiguous()


PLAIN = {"aligned": aligned_torch, "window": window_torch, "mm_highest": mm_highest_torch,
         "tri_mm": tri_mm_torch}


# ------------------------------------------------------------- wrappers ----


@functools.cache
def _entry():
    """The probes' C entry, built and resolved once."""
    return build.entry("bisect_probes", 4, 3)


def _run(probe: str, start, count, feat):
    if feat.device.type == "cpu":
        return PLAIN[probe](start, count, feat)
    dev = feat.device
    T, B = start.shape[0], feat.shape[1]
    build.check_tensor("start", start, torch.int32, (T,), dev)
    build.check_tensor("count", count, torch.int32, (T,), dev)
    build.check_tensor("feat", feat, torch.float32, (ROWS, B), dev)
    if B % CH or B < CH:
        raise ValueError(f"feat must have a positive multiple of {CH} columns, got {B} "
                         "(pad_columns pads it)")
    out = torch.empty((T, *OUT_SHAPE), dtype=torch.float32, device=dev)
    with on_device(dev):
        rc = _entry()(start.data_ptr(), count.data_ptr(), feat.data_ptr(), out.data_ptr(),
                      PROBES.index(probe), T, B, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bisect {probe} kernel launch failed with CUDA error {rc}")
    trace.count("launches.bisect", f"bisect_{probe}")
    return out


def aligned(start, count, feat):
    return _run("aligned", start, count, feat)


def window(start, count, feat):
    return _run("window", start, count, feat)


def mm_highest(start, count, feat):
    return _run("mm_highest", start, count, feat)


def tri_mm(start, count, feat):
    return _run("tri_mm", start, count, feat)


WRAPPERS = {"aligned": aligned, "window": window, "mm_highest": mm_highest, "tri_mm": tri_mm}
