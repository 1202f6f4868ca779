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
// not carried over: the wrapper sorts the valid points by (tile, pixel) and
// cuts each tile's run into work items of at most ITEM = 32 points.
//
// What bounds it on an H100: FP32 operations. Every (instance, point) pair
// of a tile is walked (no early end): ~15 FP32 operations per sample at five
// samples for the gate, and where a sample passes ~6 more and an exp; a used
// pair then pays ~40 for the ray-space quadratic form, an exp and the
// transmittance update. The bytes are one 80-byte feature row per Gaussian,
// 4 per instance and 16 + 8 bytes per point, far below.
// A 256-thread block per work item of up to 256 points (the first design)
// ran at 5-19% of that bound: at the point counts of the tetra SDF passes a
// tile holds 17-33 points, so one or two warps of a block walked while the
// others staged rows and waited at two barriers a round, and the gathers
// between the barriers were exposed. What this design does about it:
//   - a work item is one warp: at most 32 points of one tile. A block holds
//     WARPS items, which share nothing: each warp gathers its own tile's
//     rows into its own ring in shared memory and syncs with __syncwarp
//     only, so a warp whose points are done holds no other back, and every
//     resident warp walks;
//   - the rows are gathered through gauss_id by cp.async (16 bytes a copy)
//     into a ring of STAGES rounds of RB rows, STAGES - 1 rounds ahead of
//     the walk, the ids loaded one round before their copies; all lanes then
//     read the same row (a broadcast);
//   - the wrapper orders each tile's points by pixel, so the lanes of a warp
//     sit at the same or neighbouring pixels and mostly take the same gate
//     branches;
//   - the exp of a sample is skipped where its power lies below the row's
//     skip_below, ln(1/255 / opacity) less a margin: there the alpha test
//     would fail (a conic's power is never > 0, so the power test alone
//     skipped nothing); the 3D alpha is computed only for used pairs;
//   - each point has one owner: no atomics, bit-identical from run to run,
//     and a point's result depends only on its pixel and depth, not on the
//     work item that holds it.
//
// Output: out (N,) float32 alpha_integrated in the ORIGINAL point order,
// written only for the valid points the items hold (the wrapper fills 1.0
// for the others).

#include <cstddef>

#include <cuda_runtime.h>

#include "integrate_common.cuh"

using namespace radegs;

namespace {

constexpr int NF = 5;          // a feature row: 20 floats = 5 float4
constexpr int ITEM = 32;       // points per work item: one warp's lanes
constexpr int WARPS = 4;       // work items (warps) per block
constexpr int RB = 32;         // rows per round
constexpr int STAGES = 2;      // rounds in a warp's ring
constexpr int MIN_BLOCKS = 8;  // blocks resident per SM, for __launch_bounds__
constexpr unsigned FULL = 0xffffffffu;

static_assert(ITEM == 32, "a work item is one warp");
static_assert(RB >= 1 && RB <= 32, "a round's ids are held by its first RB lanes");
static_assert(STAGES >= 2, "the ring holds the round walked and one in flight");
constexpr int COPIES = (RB * NF + 31) / 32;  // 16-byte copies per lane and round
constexpr int RING = STAGES * RB * NF;  // float4 of one warp's ring

// feature row (radegs_torch/ops/integrate.py point_features): 0:2 xy,
// 2:5 conic (a, b, c), 5 opacity, 6 ts, 7:9 ray_plane, 9:15 invraycov
// [00, 01, 02, 11, 12, 22], 15 well_conditioned (1.0 or 0.0), 16 skip_below,
// 17:20 zero

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

// Issue the copies of round q (rows [q RB, q RB + RB) of the tile's run of
// n_rows, those that exist) into its stage of the warp's ring, one commit
// group per round, empty or not. Lane r < RB holds row r's Gaussian in
// `id`; copy c = lane + 32 m is part c % NF of row c / NF. Returns the ids
// of round q + 1 for the same lanes.
__device__ __forceinline__ int issue_round(float4* ring, const float4* __restrict__ feat,
                                           const int* __restrict__ gauss_id, int start,
                                           int n_rows, int q, int id, int lane) {
  float4* stage = ring + (q % STAGES) * RB * NF;
  const int r0 = q * RB;
#pragma unroll
  for (int m = 0; m < COPIES; ++m) {
    const int c = lane + 32 * m;
    const int r = c / NF;
    const int g = __shfl_sync(FULL, id, r & 31);
    if (c < RB * NF && r0 + r < n_rows)
      copy16(stage + c, feat + (size_t)g * NF + (c - r * NF));
  }
  copy_commit();
  const int rn = r0 + RB + lane;
  return (lane < RB && rn < n_rows) ? gauss_id[start + rn] : 0;
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
integrate_points_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                        const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                        const float4* __restrict__ pfeat, const int* __restrict__ order,
                        const int* __restrict__ item_tile, const int* __restrict__ item_start,
                        const int* __restrict__ item_count, float* __restrict__ out,
                        int n_items) {
  __shared__ float4 rings[WARPS * RING];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= n_items) return;  // the whole warp
  const int count = item_count[item];
  if (count == 0) return;  // an unused entry of the wrapper's fixed-length list
  float4* ring = rings + warp * RING;
  const int t = item_tile[item];
  const bool has = lane < count;
  const int i = item_start[item] + lane;
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
  const int n_rows = tile_count[t];
  int id = (lane < RB && lane < n_rows) ? gauss_id[start + lane] : 0;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q)
    id = issue_round(ring, feat, gauss_id, start, n_rows, q, id, lane);
  for (int q = 0; q * RB < n_rows; ++q) {
    copy_wait<STAGES - 2>();  // this lane's copies of round q have landed
    __syncwarp();  // every lane's copies of round q; every lane done with round q - 1
    id = issue_round(ring, feat, gauss_id, start, n_rows, q + STAGES - 1, id, lane);
    if (!has) continue;
    const float4* stage = ring + (q % STAGES) * RB * NF;
    const int n = min(RB, n_rows - q * RB);
    for (int r = 0; r < n; ++r) {
      const float* f = reinterpret_cast<const float*>(stage + r * NF);
      bool used = false;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float a, dx, dy;
        used |= corner_step(f, f[16], sx[k], sy[k], Ts[k], a, dx, dy);
      }
      if (!used) continue;
      const float apt = point_alpha(f, pt.x, pt.y, pt.z);
      if (apt < ALPHA_EPS) continue;
      a_int = __fadd_rn(a_int, __fmul_rn(apt, T_pt));
      T_pt = __fmul_rn(T_pt, 1.0f - apt);
    }
  }
  copy_wait<0>();  // no copy may land after the warp has left
  if (has) out[order[i]] = a_int;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/integrate.py. Launches
// WARPS work items per block on `stream` (an item of 0 points is skipped)
// and returns cudaGetLastError() (0 on success). `points_per_item` is the
// wrapper's cut of the items (POINTS_PER_ITEM): anything but ITEM returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int radegs_integrate_points(const void* feat, const void* gauss_id,
                                       const void* tile_start, const void* tile_count,
                                       const void* pfeat, const void* order,
                                       const void* item_tile, const void* item_start,
                                       const void* item_count, void* out, int n_items,
                                       int points_per_item, void* stream) {
  if (points_per_item != ITEM) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  const int blocks = (n_items + WARPS - 1) / WARPS;
  integrate_points_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int*>(gauss_id),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float4*>(pfeat), static_cast<const int*>(order),
      static_cast<const int*>(item_tile), static_cast<const int*>(item_start),
      static_cast<const int*>(item_count), static_cast<float*>(out), n_items);
  return static_cast<int>(cudaGetLastError());
}
