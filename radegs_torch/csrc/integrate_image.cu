// Integrate phase A of RaDe-GS on Hopper (sm_90a): per 16x16 tile, the
// front-to-back walk of the tile's depth-sorted instances at every pixel
// CENTRE, keeping five sub-pixel transmittances (centre + 4 corners at
// +-0.5 px), colour, expected / median / max depth, alpha, the centre
// transmittance T0 and the median plane that the point SDF reads — the image
// half of integrateCUDA (reference forward.cu:938-1133).
//
// Replaces the TPU kernel radegs_tpu/ops/pallas_integrate.py:_iimg_kernel
// (B5). The TPU kernel's two-bank vector/serial split exists only for the
// TPU's vector units and is not carried over: each sample is walked by one
// thread, contributor by contributor, as the reference does.
//
// What bounds it on an H100: FP32 operations. No sample ends early (a corner
// that would underflow skips a contributor, a later one may still count),
// so every instance of a tile is walked at every sample: ~15 FP32
// operations to test it (two deltas, the conic form, the power test), ~6
// more and an exp where it passes, 5 where the sample takes the contributor
// (the plane depth and the max) and ~11 per pixel centre that does (the
// accumulation). The bytes are one 64-byte feature row per Gaussian, 4 per
// instance and 14 words written per pixel, far below.
// A thread per pixel walking its five samples makes 1280 sample walks per
// tile and contributor. But a sample's transmittance and
// its decisions depend only on its position and the tile's list, and a
// corner at +-0.5 px of pixel (i, j) lands exactly (in float32) on the
// integer lattice point (x0 + i or x0 + i + 1, y0 + j or y0 + j + 1), which
// it shares with up to three other pixels. A tile has 256 centres and a
// 17 x 17 lattice of 289 distinct corners: 545 sample walks, 2.35x fewer,
// with the same bits. What this design does:
//   - NT = 576 threads a tile: warps 0-7 walk the 256 centres and keep all
//     that a pixel accumulates (colour, alpha, expected depth, T0, the
//     median and its plane, med_pos, the max depth at the centre), warps
//     8-17 walk the 289 lattice corners and keep only T and the running max
//     of the plane depth where the corner takes a contributor (31 lanes of
//     the last warp idle). At the end each pixel takes the max over its
//     centre and its four corners, k = 1 -> (i, j), 2 -> (i+1, j), 3 ->
//     (i, j+1), 4 -> (i+1, j+1), through shared memory: fmaxf is exact, so
//     the order of the maxima does not change a bit;
//   - the exp of a sample is skipped where its power lies below the row's
//     skip_below, ln(1/255 / opacity) less a margin: there the alpha test
//     would fail (a conic's power is never > 0, so the power test alone
//     skipped nothing);
//   - the rows are gathered through gauss_id by cp.async (16 bytes a copy,
//     issued by the corner warps) into a ring of STAGES rounds of RB rows,
//     STAGES - 1 rounds ahead of the walk, the ids loaded one round before
//     their copies; one barrier a round; every walker then reads the same
//     row (a broadcast);
//   - the wrapper launches the tiles heaviest first (`tile_order`): the
//     walk of one tile cannot be split (its skips depend on T), so a heavy
//     tile that starts late sets the tail;
//   - each pixel and each lattice corner has one owner: no atomics, the
//     output is bit-identical from run to run.
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

constexpr int NF = 4;          // a feature row: 16 floats = 4 float4
constexpr int N_OUT = 13;
constexpr int RB = 64;         // rows per round
constexpr int STAGES = 3;      // rounds in the ring
constexpr int MIN_BLOCKS = 2;  // tiles resident per SM, for __launch_bounds__
constexpr int LAT = TILE + 1;  // corner lattice side
constexpr int N_CORNER = LAT * LAT;
constexpr int NT = PX + (N_CORNER + 31) / 32 * 32;  // centre warps, then corner warps
constexpr int COPIES = RB * NF;  // 16-byte copies per round, one per corner thread

static_assert(COPIES <= NT - PX, "a round's copies are issued by the corner threads");
static_assert(STAGES >= 2, "the ring holds the round walked and one in flight");

// feature row (radegs_torch/ops/integrate.py image_features): 0:2 xy,
// 2:5 conic (a, b, c), 5 opacity, 6:9 rgb, 9 ts, 10:12 ray_plane,
// 12 skip_below, 13:16 zero

// The ray distance at offset (dx, dy) from the centre, rounded as the plain
// version: ts + rp0 dx + rp1 dy.
__device__ __forceinline__ float plane_depth(const float* f, float dx, float dy) {
  return __fadd_rn(__fadd_rn(f[9], __fmul_rn(f[10], dx)), __fmul_rn(f[11], dy));
}

// Issue round q's copies (rows [q RB, q RB + RB) of the tile's run of
// n_rows, those that exist) into its ring stage, one commit group per round,
// empty or not. Copy c (a corner thread's index, c < COPIES) is part c % NF
// of row c / NF, whose Gaussian it holds in `id`. Returns its id of round
// q + 1.
__device__ __forceinline__ int issue_round(float4* ring, const float4* __restrict__ feat,
                                           const int* __restrict__ gauss_id, int start,
                                           int n_rows, int q, int id, int c) {
  const bool copier = c >= 0 && c < COPIES;
  const int r = c / NF;
  if (copier && q * RB + r < n_rows)
    copy16(ring + (q % STAGES) * RB * NF + c, feat + (size_t)id * NF + (c - r * NF));
  copy_commit();
  const int rn = (q + 1) * RB + r;
  return (copier && rn < n_rows) ? gauss_id[start + rn] : 0;
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
integrate_image_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                       const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                       const int* __restrict__ tile_order, float* __restrict__ out,
                       int* __restrict__ med_pos_out, int tiles_x) {
  __shared__ float4 ring[STAGES * RB * NF];
  __shared__ float corner_max[N_CORNER];

  const int t = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int c = tid - PX;  // the corner walker's index; < 0 for the centre walkers
  const int x0 = (t % tiles_x) * TILE;
  const int y0 = (t / tiles_x) * TILE;
  const int start = tile_start[t];
  const int n_rows = tile_count[t];

  // centre walkers: pixel p's centre (+0.5, forward.cu:982); corner walkers:
  // lattice point (x0 + c % LAT, y0 + c / LAT), the corner positions
  // centre -+ 0.5 exactly
  float sx, sy;
  if (c < 0) {
    sx = __fadd_rn((float)(x0 + tid % TILE), 0.5f);
    sy = __fadd_rn((float)(y0 + tid / TILE), 0.5f);
  } else {
    sx = (float)(x0 + c % LAT);
    sy = (float)(y0 + c / LAT);
  }
  float T = 1.0f, max_d = 0.0f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, exp_d = 0.f, med_d = 0.f, acc_a = 0.f;
  float mid_dc = 0.f, mid_p0 = 0.f, mid_p1 = 0.f, mid_x = 0.f, mid_y = 0.f;
  int med_pos = -1;

  const bool copier = c >= 0 && c < COPIES;
  int id = (copier && c / NF < n_rows) ? gauss_id[start + c / NF] : 0;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q)
    id = issue_round(ring, feat, gauss_id, start, n_rows, q, id, c);
  for (int q = 0; q * RB < n_rows; ++q) {
    copy_wait<STAGES - 2>();  // this thread's copies of round q have landed
    __syncthreads();  // every thread's copies of round q; every walker done with q - 1
    id = issue_round(ring, feat, gauss_id, start, n_rows, q + STAGES - 1, id, c);
    const float4* stage = ring + (q % STAGES) * RB * NF;
    const int n = min(RB, n_rows - q * RB);
    if (c < 0) {
      for (int r = 0; r < n; ++r) {
        const float* f = reinterpret_cast<const float*>(stage + r * NF);
        // the transmittance before this contributor weights the accumulation
        const float T0_old = T;
        float a0, dx, dy;
        if (!corner_step(f, f[12], sx, sy, T, a0, dx, dy)) continue;
        const float d0 = plane_depth(f, dx, dy);
        max_d = fmaxf(max_d, d0);
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
          med_pos = q * RB + r;
        }
      }
    } else if (c < N_CORNER) {
      for (int r = 0; r < n; ++r) {
        const float* f = reinterpret_cast<const float*>(stage + r * NF);
        float a, dx, dy;
        if (corner_step(f, f[12], sx, sy, T, a, dx, dy))
          max_d = fmaxf(max_d, plane_depth(f, dx, dy));
      }
    }
  }
  copy_wait<0>();  // no copy may land after the block has left

  if (c >= 0) {
    if (c < N_CORNER) corner_max[c] = max_d;
  }
  __syncthreads();
  if (c >= 0) return;
  // the pixel's max depth over its centre and its four corners
  const int k1 = (tid / TILE) * LAT + tid % TILE;
  max_d = fmaxf(fmaxf(fmaxf(fmaxf(max_d, corner_max[k1]), corner_max[k1 + 1]),
                      corner_max[k1 + LAT]),
                corner_max[k1 + LAT + 1]);

  float* o = out + (size_t)t * N_OUT * PX + tid;
  o[0 * PX] = c0;
  o[1 * PX] = c1;
  o[2 * PX] = c2;
  o[3 * PX] = exp_d;
  o[4 * PX] = med_d;
  o[5 * PX] = max_d;
  o[6 * PX] = acc_a;
  o[7 * PX] = T;
  o[8 * PX] = mid_dc;
  o[9 * PX] = mid_p0;
  o[10 * PX] = mid_p1;
  o[11 * PX] = mid_x;
  o[12 * PX] = mid_y;
  med_pos_out[(size_t)t * PX + tid] = med_pos;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/integrate.py. Launches one
// block per tile on `stream`, block b walking tile tile_order[b] (a
// permutation of the tiles); returns cudaGetLastError() (0 on success).
extern "C" int radegs_integrate_image(const void* feat, const void* gauss_id,
                                      const void* tile_start, const void* tile_count,
                                      const void* tile_order, void* out, void* med_pos,
                                      int num_tiles, int tiles_x, void* stream) {
  if (num_tiles <= 0) return 0;
  integrate_image_kernel<<<num_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const int*>(gauss_id),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(tile_order), static_cast<float*>(out),
      static_cast<int*>(med_pos), tiles_x);
  return static_cast<int>(cudaGetLastError());
}
