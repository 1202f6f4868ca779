"""The appearance network's share of its roofline, in %: its seven
convolutions' least time over the traced steps (``benchmark/
appearance_flops.py``, forward and backward) over the device time of the
kernels that those convolutions launched in the trace (``conv_s``,
``kinds/appearance.conv_seconds``: cuDNN's forward, data- and
weight-gradient kernels, the SSIM filter's depthwise ones left out)."""


def read(record):
    t = record.get("conv_s")
    least = record.get("least", {}).get("appearance")
    if not t or least is None:
        return None
    return 100.0 * least / t
