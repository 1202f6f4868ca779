"""Device selection for the port's entry points.

Every entry point takes ``device=None``: it means the CUDA card, and raises
when there is none. The CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do); nothing falls back to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else ``torch.device(device)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "radegs_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def add_device_arg(parser):
    """``--device {cuda,cpu}`` of the command-line entry points (default
    ``cuda``, which raises without a card)."""
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to run (cpu only on request; cuda needs a card)")
