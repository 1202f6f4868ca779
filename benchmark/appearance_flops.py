"""The least time a train step's appearance network could take, forward and
backward, from the centre crop's size alone (GOF's network, whatever
implements it): its seven 3x3 convolutions' FP32 operations at the H100's
non-tensor peak (``roofline.PEAK_FP32``), or their activations' bytes at
the HBM3 peak (``roofline.PEAK_BYTES``), whichever is larger. A lower
bound, so its share of the network's device time cannot pass 100%:

- operations: a conv's forward is 2 x 9 x Cin x Cout per output pixel (an
  FMA counted as 2); its backward the same twice, once for the input's
  gradient and once for the weights'. The ReLUs, the pixel shuffles, the
  bilinear, the sigmoid, the downsample and the multiply are not counted;
- bytes: a conv's forward reads its input and writes its output once, its
  backward reads its input and its output's gradient and writes its
  input's gradient once, float32; weights are not counted.

With an (Hc, Wc) crop the network runs at (Hc / 32, Wc / 32): conv_in 67
-> 256 there, four upsample blocks (a shuffle x2, then a conv from a
quarter of the channels to 128, 64, 32, 16), a bilinear x2, conv_mid 16 ->
16 and conv_out 16 -> 3 at the crop's size.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_BYTES, PEAK_FP32

IN_CH = 3 + 64  # the downsampled crop and the view's embedding
UPSAMPLE = (256, 128, 64, 32, 16)  # conv_in's width, then each block's
OUT_CH = 3


def convs(hc: int, wc: int):
    """(Cin, Cout, pixels) of each of the seven convolutions, in order."""
    h, w = hc // 32, wc // 32
    out = [(IN_CH, UPSAMPLE[0], h * w)]
    for cin, cout in zip(UPSAMPLE, UPSAMPLE[1:]):
        h, w = 2 * h, 2 * w
        out.append((cin // 4, cout, h * w))
    h, w = 2 * h, 2 * w
    return out + [(UPSAMPLE[-1], UPSAMPLE[-1], h * w), (UPSAMPLE[-1], OUT_CH, h * w)]


def flops(hc: int, wc: int) -> int:
    """Forward and backward operations of the convolutions."""
    return sum(3 * 2 * 9 * cin * cout * n for cin, cout, n in convs(hc, wc))


def least_bytes(hc: int, wc: int) -> int:
    return sum(4 * n * ((cin + cout) + (2 * cin + cout)) for cin, cout, n in convs(hc, wc))


def least_s(hc: int, wc: int) -> float:
    return max(flops(hc, wc) / PEAK_FP32, least_bytes(hc, wc) / PEAK_BYTES)
