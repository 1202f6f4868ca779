"""The least time the blend's forward and backward could take on a view,
counted from the scene and the camera alone (``reference.render`` walks
the view and counts its pairs), never from the program's instance lists,
tiles or buffer sizes.

Operations are FP32, an FMA counted as 2, per (pixel, splat) pair:

- a pair where alpha reaches 1/255 before its pixel ended (``n_alpha``):
  the falloff and gate that need both dx and dy (5: the quadratic form's
  sum, x -0.5, (b dx) dy, the difference, the power test) and the alpha (7:
  ~4 for expf, the opacity product, the 0.99 clamp, the 1/255 test). Terms
  of dx or dy alone are counted 0, since a kernel could share them along a
  row or a column: the count stays a lower bound.
- a blended pair (``n_incl``): the forward's 34 (transmittance 3, weight 1,
  colour 6, weight sum 1, the dy halves of the depth 2 + its sum 2 and of the
  coordinate 6 + its sums 6, normal 6, median test 1); the backward's 125
  (transmittance 3, weight 1, depth 4, coordinate 12, dL/dw 21, prefix 2,
  suffix 2, dL/dalpha 3, median routing 10, the clip gate 2, dL/dG 1, the
  falloff products 2, e_x and e_y 8, the abs statistic 5, conic 9, opacity 1,
  colour 3, camera plane 6, ray plane 2, normal 3, 25 adds into the sums).

Bytes: each splat that reaches a tile (``n_splats``) read once as its 24
feature floats; the forward writes 17 floats a pixel (16 accumulators and the
median's index); the backward reads 16 cotangents and 16 forward values a
pixel and writes 25 gradient floats a splat.

Time is the larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s,
the H100 SXM's published FP32 (non-tensor) and HBM3 peaks at its 700 W
limit.
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PAIR_ALPHA = 5 + 7
OPS_FWD_BLEND = 34
OPS_BWD_BLEND = 125
FEATURE_FLOATS = 24


def least_fwd_s(counts: dict, width: int, height: int) -> float:
    ops = OPS_PAIR_ALPHA * counts["n_alpha"] + OPS_FWD_BLEND * counts["n_incl"]
    nbytes = 4 * (counts["n_splats"] * FEATURE_FLOATS + width * height * 17)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def least_bwd_s(counts: dict, width: int, height: int) -> float:
    ops = OPS_PAIR_ALPHA * counts["n_alpha"] + OPS_BWD_BLEND * counts["n_incl"]
    nbytes = 4 * (counts["n_splats"] * (FEATURE_FLOATS + 25) + width * height * 32)
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def count_view(state, cam, kernel_size: float) -> dict:
    """The pair counts of one view of a program state's active splats
    (their parameters and 3D filter are the scene) from the reference
    camera ``cam``, walked by the reference's blend."""
    from benchmark.reference import fp32
    from benchmark.reference import render as rr

    act = state.active
    params = {k: v[act] for k, v in state.params.items()}
    with fp32():
        _, counts = rr.render(params, state.filter_3d[act], cam, kernel_size,
                              state.active_sh_degree, count=True)
    return counts
