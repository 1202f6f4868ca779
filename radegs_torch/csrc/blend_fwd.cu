// Forward alpha blend of RaDe-GS on Hopper (sm_90a): per 16x16 tile, the
// front-to-back blend of the tile's depth-sorted instances into colour,
// weight, ray distance, camera coordinate, normal, median and final
// transmittance — the forward pass of renderCUDA (reference forward.cu:428-693).
//
// Replaces the TPU kernels
//   radegs_tpu/ops/pallas_blend.py:_fwd_kernel        (B1, one tile per program)
//   radegs_tpu/ops/pallas_blend_mt.py:_fwd_kernel_mt  (B3, G tiles per program)
// as ONE kernel whose template parameter G (1 or 2) is the number of tiles a
// block runs; the two give bit-identical outputs. The TPU kernels' cumprod /
// MXU-affine reformulation is not carried over: a thread walks its pixel's
// contributors one by one, as the reference does.
//
// What bounds it on an H100: FP32 operations. Each (instance, pixel) pair a
// thread walks costs ~15 FP32 operations to test (two deltas, the conic
// quadratic form, an exp, the 1/255 gate) and ~40 more when it blends. The
// bytes are one 96-byte feature row per Gaussian, 4 per instance, and 18
// words written per pixel: at the 1600x1200 view of the 100k-Gaussian scene
// in chip_smoke.py that is 5.4e9 operations against 0.15 GB, so at the
// H100's published peaks (67 TFLOP/s FP32, 3.35 TB/s) the operations take
// about 1.8x as long as the bytes.
// What the design does about it:
//   - one thread per pixel, 256 per tile: no redundant work per pair, and a
//     pixel stops at T < 1e-4 as the reference does;
//   - instances are staged 256 at a time into shared memory, gathered
//     through gauss_id from a (P, 24) feature table in float4 loads; all
//     threads of a warp then read the same row (a shared-memory broadcast);
//   - a block leaves as soon as none of its pixels has work left
//     (__syncthreads_count), so opaque tiles end early;
//   - G = 2 runs two consecutive tiles, whose runs are contiguous in the
//     sorted instance list, over one staged window (B3's combined window).
//
// Output: out (T, 17, 256) float32, rows [0:3] colour, [3] weight, [4] ray
// distance, [5:8] coord, [8:11] normal, [11] median t, [12:15] median coord,
// [15] final T, [16] median index as a float value (the row layout of
// pallas_blend.py:28-30); med_pos (T, 256) int32, the median contributor's
// index within its tile's run, -1 for none.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

#include "blend_common.cuh"

using namespace radegs;

namespace {

constexpr int BATCH = 256;  // instances staged per round
constexpr int N_OUT = 17;

template <int G>
__global__ void __launch_bounds__(G * PX)
blend_fwd_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 float* __restrict__ out, int* __restrict__ med_pos_out,
                 int num_tiles, int tiles_x) {
  __shared__ float4 rows[BATCH * NF4];

  const int j = threadIdx.x / PX;  // tile of this thread within the block
  const int p = threadIdx.x - j * PX;
  const int t = blockIdx.x * G + j;
  const bool has_tile = t < num_tiles;

  // [lo, hi): the union of the block's runs, one interval because
  // consecutive tiles' runs are adjacent in the (tile, depth)-sorted list
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int tk = blockIdx.x * G + k;
    if (tk < num_tiles && tile_count[tk] > 0) {
      lo = min(lo, tile_start[tk]);
      hi = max(hi, tile_start[tk] + tile_count[tk]);
    }
  }
  const int start = has_tile ? tile_start[t] : 0;
  const int end = has_tile ? start + tile_count[t] : 0;
  const int tt = has_tile ? t : 0;
  const float pix_x = (float)((tt % tiles_x) * TILE + p % TILE);
  const float pix_y = (float)((tt / tiles_x) * TILE + p / TILE);

  float T = 1.0f;
  bool done = end == start;  // an empty tile (or none) has nothing to walk
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, wsum = 0.f, dist = 0.f;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float med_t = 0.f, m0 = 0.f, m1 = 0.f, m2 = 0.f;
  int med_pos = -1;

  for (int b0 = lo; b0 < hi; b0 += BATCH) {
    const int n = min(BATCH, hi - b0);
    stage_rows(rows, feat, gauss_id, b0, n, threadIdx.x, G * PX);
    __syncthreads();
    const int r1 = min(end, b0 + n) - b0;
    for (int r = max(start, b0) - b0; r < r1 && !done; ++r) {
      const float* f = reinterpret_cast<const float*>(rows + r * NF4);
      const float dx = f[0] - pix_x;
      const float dy = f[1] - pix_y;
      const float power = gate_power(f, dx, dy);
      if (power > 0.0f) continue;
      const float alpha = gate_alpha(f[5], expf(power));
      if (alpha < ALPHA_EPS) continue;
      const float next_T = gate_next_t(T, alpha);
      if (next_T < T_EPS) {  // this contributor is excluded; T stays
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * f[6];
      c1 += w * f[7];
      c2 += w * f[8];
      wsum += w;
      const float t_ray = f[9] + f[10] * dx + f[11] * dy;
      dist += w * t_ray;
      const float cx = f[12] + f[15] * dx + f[18] * dy;
      const float cy = f[13] + f[16] * dx + f[19] * dy;
      const float cz = f[14] + f[17] * dx + f[20] * dy;
      x0 += w * cx;
      x1 += w * cy;
      x2 += w * cz;
      n0 += w * f[21];
      n1 += w * f[22];
      n2 += w * f[23];
      if (T > 0.5f) {  // median: the last included contributor with T > 0.5
        med_t = t_ray;
        m0 = cx;
        m1 = cy;
        m2 = cz;
        med_pos = b0 + r - start;
      }
      T = next_T;
    }
    // also the barrier before the next round overwrites `rows`
    if (__syncthreads_count(done || end <= b0 + n) == G * PX) break;
  }
  if (!has_tile) return;

  float* o = out + (size_t)t * N_OUT * PX + p;
  o[0 * PX] = c0;
  o[1 * PX] = c1;
  o[2 * PX] = c2;
  o[3 * PX] = wsum;
  o[4 * PX] = dist;
  o[5 * PX] = x0;
  o[6 * PX] = x1;
  o[7 * PX] = x2;
  o[8 * PX] = n0;
  o[9 * PX] = n1;
  o[10 * PX] = n2;
  o[11 * PX] = med_t;
  o[12 * PX] = m0;
  o[13 * PX] = m1;
  o[14 * PX] = m2;
  o[15 * PX] = T;
  o[16 * PX] = (float)med_pos;
  med_pos_out[(size_t)t * PX + p] = med_pos;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/blend.py. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int radegs_blend_fwd(const void* feat, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                void* out, void* med_pos, int num_tiles, int tiles_x,
                                int tiles_per_block, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float4*>(feat);
  const auto* g = static_cast<const int*>(gauss_id);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* tc = static_cast<const int*>(tile_count);
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<int*>(med_pos);
  if (tiles_per_block == 1) {
    blend_fwd_kernel<1><<<num_tiles, PX, 0, s>>>(f, g, ts, tc, o, m, num_tiles, tiles_x);
  } else if (tiles_per_block == 2) {
    blend_fwd_kernel<2><<<(num_tiles + 1) / 2, 2 * PX, 0, s>>>(f, g, ts, tc, o, m,
                                                                num_tiles, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
