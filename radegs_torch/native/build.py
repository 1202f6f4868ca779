"""Build of the port's CUDA kernels: ``nvcc`` compiles each
``radegs_torch/csrc/<name>.cu`` into its own shared library with a plain C
interface, which the op modules load with ``ctypes``.

- Target ``sm_90a`` (Hopper; the ``a`` admits ``wgmma`` and ``setmaxnreg``).
- Output under ``build/radegs_torch/`` at the repository root (git-ignored),
  named by a hash of the sources, headers and flags, so a changed source is
  rebuilt and an unchanged one is loaded as it is.
- One ``nvcc`` per source, all started together.
- The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
  is kept beside each library as ``<name>-<hash>.log``.
- A failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "radegs_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Build the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all running at once. Returns the seconds
    each build took (0.0 for one already built); raises on any failure."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      log, tmp, so, time.perf_counter())
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, so, t0) in jobs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n{so.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def entry(name: str, n_ptr: int, n_int: int):
    """The C entry ``radegs_<name>`` of kernel ``name``, built at first use,
    with its ctypes signature: ``n_ptr`` pointers, ``n_int`` ints, then the
    stream; it returns the launch's cudaError_t (0 on success)."""
    fn = getattr(load(name), f"radegs_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_tensor(name: str, x, dtype, shape, device):
    """Raise unless kernel input ``name`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device`` (the kernels take raw pointers)."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"kernel input {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (empty if it was built by another run)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
