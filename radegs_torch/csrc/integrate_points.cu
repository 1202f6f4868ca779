// Integrate phase B of RaDe-GS on Hopper (sm_90a): for every query point,
// the front-to-back walk of its tile's depth-sorted instances, re-deciding
// at the point's pixel centre which contributors the pixel's five
// sub-pixel samples take (the "used" gate), and accumulating the ray-space
// 3D opacity of the used ones into the point's transmittance — the point
// half of integrateCUDA (reference forward.cu:1150-1339), the inner loop of
// Marching-Tetrahedra extraction.
//
// Replaces the TPU kernel radegs_tpu/ops/pallas_integrate.py:_pint_kernel
// (B6). The TPU kernel's 128-lane point windows (bin_points_aligned) are
// not carried over: the wrapper sorts the valid points by tile and cuts each
// tile's run into work items of at most 256 points, one block per item, so a
// tile holding 100k points spreads over ~400 blocks.
//
// What bounds it on an H100: FP32 operations. Every (instance, point) pair
// of a tile is walked (no early end): ~15 FP32 operations per sample at five
// samples for the gate, and where a sample passes ~6 more and an exp; a used
// pair then pays ~40 for the ray-space quadratic form, an exp and the
// transmittance update. The bytes are one 64-byte feature row per Gaussian,
// 4 per instance and 16 + 8 bytes per point, far below.
// What the design does about it:
//   - one thread per point; all threads of a block share one tile, so the
//     staged instance rows (256 at a time in shared memory, gathered
//     through gauss_id in float4 loads) are read as broadcasts;
//   - the exp of a sample is skipped where its power test fails, and the
//     3D alpha only computed for used pairs;
//   - each point has one owner: no atomics, bit-identical from run to run.
//
// Output: out (N,) float32 alpha_integrated in the ORIGINAL point order,
// written only for the valid points the items hold (the wrapper fills 1.0
// for the others).

#include <cstddef>

#include <cuda_runtime.h>

#include "integrate_common.cuh"

using namespace radegs;

namespace {

constexpr int BATCH = 256;  // instances staged per round
constexpr int NF = 4;       // a feature row: 16 floats = 4 float4
constexpr int ITEM = 256;   // points per work item (threads per block)

// feature row (radegs_torch/ops/integrate.py point_features): 0:2 xy,
// 2:5 conic (a, b, c), 5 opacity, 6 ts, 7:9 ray_plane, 9:15 invraycov
// [00, 01, 02, 11, 12, 22], 15 well_conditioned (1.0 or 0.0)

// The ray-space alpha of row f at the point (x, y, depth), rounded op by op
// as _point_alpha of the plain version (integrate.py:259-273, with the
// reference's ill-conditioned quirk: dz = ts, and no alpha in front of the
// plane).
__device__ __forceinline__ float point_alpha(const float* f, float x, float y, float depth) {
  const float dx = __fsub_rn(f[0], x);
  const float dy = __fsub_rn(f[1], y);
  const float t_at = __fadd_rn(__fadd_rn(f[6], __fmul_rn(f[7], dx)), __fmul_rn(f[8], dy));
  const bool cond = f[15] > 0.5f;
  const float dz = cond ? __fsub_rn(f[6], fminf(depth, t_at)) : f[6];
  const float diag = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(f[9], dx), dx),
                                         __fmul_rn(__fmul_rn(f[12], dy), dy)),
                               __fmul_rn(__fmul_rn(f[14], dz), dz));
  const float off = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(f[10], dx), dy),
                                        __fmul_rn(__fmul_rn(f[11], dx), dz)),
                              __fmul_rn(__fmul_rn(f[13], dy), dz));
  const float pw = __fmul_rn(-0.5f, __fadd_rn(diag, __fmul_rn(2.0f, off)));
  const float apt = gate_alpha(f[5], expf(fminf(pw, 0.0f)));
  return (cond || depth >= t_at) ? apt : 0.0f;
}

__global__ void __launch_bounds__(ITEM)
integrate_points_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                        const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                        const float4* __restrict__ pfeat, const int* __restrict__ order,
                        const int* __restrict__ item_tile, const int* __restrict__ item_start,
                        const int* __restrict__ item_count, float* __restrict__ out) {
  __shared__ float4 rows[BATCH * NF];

  const int item = blockIdx.x;
  const int t = item_tile[item];
  const int j = threadIdx.x;
  const bool has = j < item_count[item];
  const int i = item_start[item] + j;
  const float4 pt = has ? pfeat[i] : make_float4(0.f, 0.f, 0.f, 0.f);  // x, y, depth
  // the point's pixel centre and its 5 samples (floor(xy) + 0.5 + offset)
  float sx[5], sy[5], Ts[5];
  const float pcx = __fadd_rn(floorf(pt.x), 0.5f);
  const float pcy = __fadd_rn(floorf(pt.y), 0.5f);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    sx[k] = __fadd_rn(pcx, OFF_X[k]);
    sy[k] = __fadd_rn(pcy, OFF_Y[k]);
    Ts[k] = 1.0f;
  }
  float T_pt = 1.0f, a_int = 0.0f;

  const int start = tile_start[t];
  const int end = start + tile_count[t];
  for (int b0 = start; b0 < end; b0 += BATCH) {
    const int n = min(BATCH, end - b0);
    stage_rows_n<NF>(rows, feat, gauss_id, b0, n, j, ITEM);
    __syncthreads();
    if (has) {
      for (int r = 0; r < n; ++r) {
        const float* f = reinterpret_cast<const float*>(rows + r * NF);
        bool used = false;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          float a, dx, dy;
          used |= corner_step(f, sx[k], sy[k], Ts[k], a, dx, dy);
        }
        if (!used) continue;
        const float apt = point_alpha(f, pt.x, pt.y, pt.z);
        if (apt < ALPHA_EPS) continue;
        a_int = __fadd_rn(a_int, __fmul_rn(apt, T_pt));
        T_pt = __fmul_rn(T_pt, 1.0f - apt);
      }
    }
    __syncthreads();  // before the next round overwrites `rows`
  }
  if (has) out[order[i]] = a_int;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/integrate.py. Launches one
// block per work item on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int radegs_integrate_points(const void* feat, const void* gauss_id,
                                       const void* tile_start, const void* tile_count,
                                       const void* pfeat, const void* order,
                                       const void* item_tile, const void* item_start,
                                       const void* item_count, void* out, int n_items,
                                       void* stream) {
  if (n_items <= 0) return 0;
  integrate_points_kernel<<<n_items, ITEM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int*>(gauss_id),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float4*>(pfeat), static_cast<const int*>(order),
      static_cast<const int*>(item_tile), static_cast<const int*>(item_start),
      static_cast<const int*>(item_count), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
