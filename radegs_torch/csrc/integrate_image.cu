// Integrate phase A of RaDe-GS on Hopper (sm_90a): per 16x16 tile, the
// front-to-back walk of the tile's depth-sorted instances at every pixel
// CENTRE, keeping five sub-pixel transmittances (centre + 4 corners at
// +-0.5 px), colour, expected / median / max depth, alpha, the centre
// transmittance T0 and the median plane that the point SDF reads — the image
// half of integrateCUDA (reference forward.cu:938-1133).
//
// Replaces the TPU kernel radegs_tpu/ops/pallas_integrate.py:_iimg_kernel
// (B5). The TPU kernel's two-bank vector/serial split exists only for the
// TPU's vector units and is not carried over: one thread walks its pixel's
// contributors one by one, as the reference does.
//
// What bounds it on an H100: FP32 operations. No pixel ends early (a corner
// that would underflow skips a contributor, a later one may still count),
// so every (instance, pixel) pair is walked, at five samples each: ~15 FP32
// operations per sample to test it (two deltas, the conic form, the power
// test), ~6 more and an exp where it passes, and ~20 per pair for the
// centre's accumulation. The bytes are one 48-byte feature row per Gaussian,
// 4 per instance and 14 words written per pixel, far below.
// What the design does about it:
//   - one thread per pixel, 256 per tile, no redundant work per pair; the
//     exp is skipped where the power test already fails;
//   - instances are staged 256 at a time into shared memory, gathered
//     through gauss_id from a (P, 12) feature table in float4 loads; all
//     threads of the block then read the same row (a broadcast);
//   - each pixel has one owner, so no atomics: the output is bit-identical
//     from run to run.
//
// Output: out (T, 13, 256) float32, rows [0:3] colour (before the
// background), [3] expected depth sum, [4] median depth, [5] max depth (0
// where no sample took a contributor, as the XLA path), [6] alpha, [7] T0,
// [8:13] the median plane (mid_dc, mid_p0, mid_p1, mid_x, mid_y); med_pos
// (T, 256) int32, the median contributor's index in its tile's run, -1 for
// none.

#include <cstddef>

#include <cuda_runtime.h>

#include "integrate_common.cuh"

using namespace radegs;

namespace {

constexpr int BATCH = 256;  // instances staged per round
constexpr int NF = 3;       // a feature row: 12 floats = 3 float4
constexpr int N_OUT = 13;

// feature row (radegs_torch/ops/integrate.py image_features): 0:2 xy,
// 2:5 conic (a, b, c), 5 opacity, 6:9 rgb, 9 ts, 10:12 ray_plane

// The ray distance at offset (dx, dy) from the centre, rounded as the plain
// version: ts + rp0 dx + rp1 dy.
__device__ __forceinline__ float plane_depth(const float* f, float dx, float dy) {
  return __fadd_rn(__fadd_rn(f[9], __fmul_rn(f[10], dx)), __fmul_rn(f[11], dy));
}

__global__ void __launch_bounds__(PX)
integrate_image_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                       const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                       float* __restrict__ out, int* __restrict__ med_pos_out, int tiles_x) {
  __shared__ float4 rows[BATCH * NF];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int end = start + tile_count[t];
  // pixel centre (+0.5, forward.cu:982)
  const float px = __fadd_rn((float)((t % tiles_x) * TILE + p % TILE), 0.5f);
  const float py = __fadd_rn((float)((t / tiles_x) * TILE + p / TILE), 0.5f);
  float sx[5], sy[5], Ts[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    sx[k] = __fadd_rn(px, OFF_X[k]);
    sy[k] = __fadd_rn(py, OFF_Y[k]);
    Ts[k] = 1.0f;
  }
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, exp_d = 0.f, med_d = 0.f, max_d = 0.f, acc_a = 0.f;
  float mid_dc = 0.f, mid_p0 = 0.f, mid_p1 = 0.f, mid_x = 0.f, mid_y = 0.f;
  int med_pos = -1;

  for (int b0 = start; b0 < end; b0 += BATCH) {
    const int n = min(BATCH, end - b0);
    stage_rows_n<NF>(rows, feat, gauss_id, b0, n, p, PX);
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float* f = reinterpret_cast<const float*>(rows + r * NF);
      // the centre sample first: its transmittance before this contributor
      // weights the accumulation
      const float T0_old = Ts[0];
      float a0, dx, dy;
      const bool ok0 = corner_step(f, sx[0], sy[0], Ts[0], a0, dx, dy);
      const float d0 = plane_depth(f, dx, dy);
      if (ok0) max_d = fmaxf(max_d, d0);
#pragma unroll
      for (int k = 1; k < 5; ++k) {
        float a, kx, ky;
        if (corner_step(f, sx[k], sy[k], Ts[k], a, kx, ky))
          max_d = fmaxf(max_d, plane_depth(f, kx, ky));
      }
      if (!ok0) continue;
      const float w = __fmul_rn(a0, T0_old);
      c0 = __fadd_rn(c0, __fmul_rn(w, f[6]));
      c1 = __fadd_rn(c1, __fmul_rn(w, f[7]));
      c2 = __fadd_rn(c2, __fmul_rn(w, f[8]));
      acc_a = __fadd_rn(acc_a, w);
      exp_d = __fadd_rn(exp_d, __fmul_rn(w, d0));
      if (T0_old > 0.5f) {  // median: the last included contributor with T0 > 0.5
        med_d = d0;
        mid_dc = f[9];
        mid_p0 = f[10];
        mid_p1 = f[11];
        mid_x = f[0];
        mid_y = f[1];
        med_pos = b0 + r - start;
      }
    }
    __syncthreads();  // before the next round overwrites `rows`
  }

  float* o = out + (size_t)t * N_OUT * PX + p;
  o[0 * PX] = c0;
  o[1 * PX] = c1;
  o[2 * PX] = c2;
  o[3 * PX] = exp_d;
  o[4 * PX] = med_d;
  o[5 * PX] = max_d;
  o[6 * PX] = acc_a;
  o[7 * PX] = Ts[0];
  o[8 * PX] = mid_dc;
  o[9 * PX] = mid_p0;
  o[10 * PX] = mid_p1;
  o[11 * PX] = mid_x;
  o[12 * PX] = mid_y;
  med_pos_out[(size_t)t * PX + p] = med_pos;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/integrate.py. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int radegs_integrate_image(const void* feat, const void* gauss_id,
                                      const void* tile_start, const void* tile_count,
                                      void* out, void* med_pos, int num_tiles, int tiles_x,
                                      void* stream) {
  if (num_tiles <= 0) return 0;
  integrate_image_kernel<<<num_tiles, PX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int*>(gauss_id),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<float*>(out), static_cast<int*>(med_pos), tiles_x);
  return static_cast<int>(cudaGetLastError());
}
