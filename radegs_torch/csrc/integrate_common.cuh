// What the two integrate kernels (integrate_image.cu, integrate_points.cu)
// share: the 5 sub-pixel sample offsets and the corner step that decides,
// per contributor, whether a sample's transmittance takes it or skips it.
// The arithmetic is rounded op by op in the order of the plain versions in
// radegs_torch/ops/integrate.py (no FMA contraction), so the kernels and
// the plain versions take the same skip / include decisions.

#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace radegs {

// centre + 4 corners at +-0.5 px (forward.cu:1020-1021)
__constant__ const float OFF_X[5] = {0.0f, -0.5f, 0.5f, -0.5f, 0.5f};
__constant__ const float OFF_Y[5] = {0.0f, -0.5f, -0.5f, 0.5f, 0.5f};

// One contributor (row f: xy, conic, opacity first) at one sample (sx, sy)
// against that sample's transmittance T. Returns whether the sample takes
// it (forward.cu:1063-1086): the power is <= 0, alpha >= 1/255 and
// T (1 - alpha) stays >= 1e-4; then T becomes T (1 - alpha). A sample that
// would underflow SKIPS the contributor and keeps walking (it does not end,
// unlike the blend). `dx`, `dy` are set for the caller, and `alpha` where it
// returns true.
// `skip` is the row's skip_below (radegs_torch/ops/integrate.py): below it
// o expf(power) < 1/255 for certain, so the sample skips the contributor
// without the exp, as the full test would.
__device__ __forceinline__ bool corner_step(const float* f, float skip, float sx, float sy,
                                            float& T, float& alpha, float& dx, float& dy) {
  dx = __fsub_rn(f[0], sx);
  dy = __fsub_rn(f[1], sy);
  const float power = gate_power(f, dx, dy);
  if (power > 0.0f || power < skip) return false;
  alpha = gate_alpha(f[5], expf(power));
  if (alpha < ALPHA_EPS) return false;
  const float test = gate_next_t(T, alpha);
  if (test < T_EPS) return false;
  T = test;
  return true;
}

}  // namespace radegs
