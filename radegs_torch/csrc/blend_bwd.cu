// Backward alpha blend of RaDe-GS on Hopper (sm_90a): per 16x16 tile, the
// front-to-back re-walk of the tile's depth-sorted instances that turns the
// cotangents of the forward's raw outputs into per-Gaussian gradients of xy,
// conic, opacity, rgb, view_point, camera_plane, ray_plane, normal, ts and
// the GOF densification side channel xy_abs (reference backward.cu:631-1016).
//
// Replaces the TPU kernels
//   radegs_tpu/ops/pallas_blend.py:_bwd_kernel         (B2, one tile per program)
//   radegs_tpu/ops/pallas_blend_mt.py:_bwd_kernel_mt   (B4, G tiles per program)
// and their XLA instance-to-Gaussian reduction (pallas_blend.py:_reduce_grad_rows)
// as two kernels launched back to back:
//   1. blend_bwd_kernel<G>: G tiles per block (1 or 2, bit-identical), one
//      thread per pixel. Each pixel walks its contributors with the
//      forward's gates (blend_common.cuh), carrying its transmittance T and
//      ONE prefix scalar sum(w dL/dw): the cotangents are constant along a
//      pixel's walk, so "everything behind me" is (s_tot - prefix) + g_tf T_final
//      with s_tot = sum over channels of cotangent x forward total (the
//      identity of pallas_blend.py:738-743). Each contributor's 25 values are
//      summed over the tile's 256 pixels by a fixed tree (a warp
//      reduce-scatter, then the 8 warps' partials in shared memory in warp
//      order) and written as one 25-float row at the instance's sorted
//      position. Rows the walk never reaches (after every pixel of the tile
//      ended, or past the max_per_tile cut) are written as zeros.
//   2. grad_segment_sum: one warp per Gaussian adds its instances' rows in
//      sorted-position order (the wrapper's stable sort of gauss_id).
// No atomics: two runs, and G = 1 against G = 2, give the same bits.
//
// The TPU machinery is not carried over: no 128-lane windows, no VMEM
// compaction ring, no bf16 MXU contractions (all FP32 here), no 19-row affine
// basis, no speculative prefetch.
//
// What bounds it on an H100: FP32 operations. A walked (instance, pixel)
// pair costs the forward's gate (~19 operations); a blended pair ~125 more
// (the gradient terms, and the 25 sums the reduction adds it into; the count
// is itemised in chip_smoke.py). The bytes
// are the forward's (a 96-byte feature row per Gaussian, 4 per instance),
// 29 words of cotangents, totals and median index per pixel, and the 100-byte
// instance rows written once and read once. What the design does about it:
//   - one thread per pixel, so the gate and gradient terms are done once per
//     pair; a warp with no blended pixel skips its reduction;
//   - the reduction is a reduce-scatter (31 shuffles for 32 values, not 5
//     per value), and each tile's 8 warps sync on their own named barrier,
//     so the two tiles of a G = 2 block never wait for each other;
//   - a tile stops walking when all its pixels have ended (T < 1e-4).
//
// Inputs: feat (P, 24) float32 (blend_common.cuh layout), gauss_id (N,),
// tile_start / tile_count (T,), aux (T, 28, 256) float32 cotangents and
// forward totals (layout in radegs_torch/ops/blend.py:pack_aux), med_pos
// (T, 256) int32. Output: grad (P, 25) float32 in the row layout of
// pallas_blend.py:579-581; inst_rows (N, 25) is scratch.

#include <cstddef>

#include <cuda_runtime.h>

#include "blend_common.cuh"

using namespace radegs;

namespace {

constexpr int N_GRAD = 25;
constexpr int N_AUX = 28;
constexpr int WARPS = PX / 32;  // warps per tile
constexpr int BATCH = 64;       // instances staged per round, per tile
constexpr int RB = 16;          // instances per reduction round
constexpr unsigned FULL = 0xffffffffu;

// barrier of one tile's 256 threads (id 0 is __syncthreads')
__device__ __forceinline__ void tile_sync(int j) {
  asm volatile("bar.sync %0, %1;" ::"r"(j + 1), "r"(PX) : "memory");
}

// One step of the warp reduce-scatter: a lane keeps the half of its S values
// selected by bit S of its lane index and adds its partner's copy of it.
template <int S>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, S);
  }
}

// After five steps lane l holds the warp's sum of v[l].
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}

template <int G>
__global__ void __launch_bounds__(G * PX)
blend_bwd_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 const float* __restrict__ aux, const int* __restrict__ med_pos,
                 float* __restrict__ inst_rows, int num_tiles, int tiles_x, int n_inst,
                 float half_w, float half_h) {
  __shared__ float4 rows[G][BATCH * NF4];
  __shared__ float part[G][RB][WARPS][32];
  __shared__ int wdone[G][WARPS];

  const int j = threadIdx.x / PX;  // tile of this thread within the block
  const int p = threadIdx.x - j * PX;
  const int lane = p & 31;
  const int w = p >> 5;
  const int t = blockIdx.x * G + j;
  if (t >= num_tiles) return;  // only this tile's threads use its barrier

  const int start = tile_start[t];
  const int end = start + tile_count[t];
  // the tile's rows in the sorted list, including those past the cut
  const int full_end = t + 1 < num_tiles ? tile_start[t + 1] : n_inst;
  const float pix_x = (float)((t % tiles_x) * TILE + p % TILE);
  const float pix_y = (float)((t / tiles_x) * TILE + p / TILE);

  const float* a = aux + (size_t)t * N_AUX * PX + p;
  float gc[3], gx[3], gn[3], gmx[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gc[k] = a[k * PX];
    gx[k] = a[(5 + k) * PX];
    gn[k] = a[(8 + k) * PX];
    gmx[k] = a[(13 + k) * PX];
  }
  const float gw = a[3 * PX], gd = a[4 * PX], gtf = a[11 * PX], gmt = a[12 * PX];
  float s_tot = gw * a[19 * PX] + gd * a[20 * PX];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_tot = s_tot + gc[k] * a[(16 + k) * PX] + gn[k] * a[(24 + k) * PX] +
            gx[k] * a[(21 + k) * PX];
  }
  const float s_fin = gtf * a[27 * PX];
  const int mp = med_pos[(size_t)t * PX + p];

  float T = 1.0f, pre = 0.0f;
  bool done = false;
  bool tile_done = end == start;  // uniform over the tile
  int next_row = start;           // first row of the tile not written yet
  float4* srows = rows[j];

  for (int b0 = start; b0 < end && !tile_done; b0 += BATCH) {
    const int n = min(BATCH, end - b0);
    stage_rows(srows, feat, gauss_id, b0, n, p, PX);
    tile_sync(j);
    for (int rr = 0; rr < n && !tile_done; rr += RB) {
      const int nr = min(RB, n - rr);
      for (int i = 0; i < nr; ++i) {
        const float* f = reinterpret_cast<const float*>(srows + (rr + i) * NF4);
        float v[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) v[c] = 0.0f;
        bool blended = false;
        if (!done) {
          const float dx = f[0] - pix_x;
          const float dy = f[1] - pix_y;
          const float power = gate_power(f, dx, dy);
          if (power <= 0.0f) {
            const float fall = expf(power);
            const float alpha = gate_alpha(f[5], fall);
            if (alpha >= ALPHA_EPS) {
              const float next_T = gate_next_t(T, alpha);
              if (next_T < T_EPS) {  // excluded; the pixel is done
                done = true;
              } else {
                blended = true;
                const float wt = alpha * T;
                const float t_ray = f[9] + f[10] * dx + f[11] * dy;
                const float cx = f[12] + f[15] * dx + f[18] * dy;
                const float cy = f[13] + f[16] * dx + f[19] * dy;
                const float cz = f[14] + f[17] * dx + f[20] * dy;
                // dL/dw: the direct path through this contributor's weight
                const float dL_dw = gc[0] * f[6] + gc[1] * f[7] + gc[2] * f[8] +
                                    gn[0] * f[21] + gn[1] * f[22] + gn[2] * f[23] + gw +
                                    gd * t_ray + gx[0] * cx + gx[1] * cy + gx[2] * cz;
                pre += wt * dL_dw;  // inclusive prefix
                const float suffix = (s_tot - pre) + s_fin;
                const float dL_dalpha = T * dL_dw - suffix / (1.0f - alpha);
                // median routing (backward.cu:909-936)
                const bool is_med = b0 + rr + i - start == mp;
                const float dL_dt = wt * gd + (is_med ? gmt : 0.0f);
                const float d0 = wt * gx[0] + (is_med ? gmx[0] : 0.0f);
                const float d1 = wt * gx[1] + (is_med ? gmx[1] : 0.0f);
                const float d2 = wt * gx[2] + (is_med ? gmx[2] : 0.0f);
                // alpha -> (opacity, falloff) through the 0.99 clip gate
                const float dL_draw = f[5] * fall < MAX_ALPHA ? dL_dalpha : 0.0f;
                const float dL_dG = dL_draw * f[5];
                const float gdx = fall * dx, gdy = fall * dy;
                const float e_x = dL_dG * (-gdx * f[2] - gdy * f[3]);
                const float e_y = dL_dG * (-gdy * f[4] - gdx * f[3]);
                v[0] = e_x;
                v[1] = e_y;
                v[2] = fabsf(e_x) * half_w + fabsf(e_y) * half_h;
                v[3] = -0.5f * gdx * dx * dL_dG;
                v[4] = -gdx * dy * dL_dG;  // the off-diagonal appears twice in power
                v[5] = -0.5f * gdy * dy * dL_dG;
                v[6] = dL_draw * fall;
                v[7] = wt * gc[0];
                v[8] = wt * gc[1];
                v[9] = wt * gc[2];
                v[10] = d0;
                v[11] = d1;
                v[12] = d2;
                v[13] = d0 * dx;
                v[14] = d1 * dx;
                v[15] = d2 * dx;
                v[16] = d0 * dy;
                v[17] = d1 * dy;
                v[18] = d2 * dy;
                v[19] = dL_dt * dx;
                v[20] = dL_dt * dy;
                v[21] = wt * gn[0];
                v[22] = wt * gn[1];
                v[23] = wt * gn[2];
                v[24] = dL_dt;
                T = next_T;
              }
            }
          }
        }
        // a warp with no blended pixel has only zeros to add
        const float s = __any_sync(FULL, blended) ? warp_reduce_scatter(v, lane) : 0.0f;
        if (lane < N_GRAD) part[j][i][w][lane] = s;
      }
      const bool warp_done = __all_sync(FULL, done);
      if (lane == 0) wdone[j][w] = warp_done;
      tile_sync(j);
      // warp w writes the rows of instances w, w + 8: the 8 warps' partials
      // in warp order, then the ray-plane and camera-plane terms of d(xy)
      for (int i = w; i < nr; i += WARPS) {
        float s = 0.0f;
        if (lane < N_GRAD) {
#pragma unroll
          for (int k = 0; k < WARPS; ++k) s += part[j][i][k][lane];
        }
        const float* f = reinterpret_cast<const float*>(srows + (rr + i) * NF4);
        const float s_t = __shfl_sync(FULL, s, 24);
        const float c0 = __shfl_sync(FULL, s, 10);
        const float c1 = __shfl_sync(FULL, s, 11);
        const float c2 = __shfl_sync(FULL, s, 12);
        if (lane == 0) s += f[10] * s_t + f[15] * c0 + f[16] * c1 + f[17] * c2;
        if (lane == 1) s += f[11] * s_t + f[18] * c0 + f[19] * c1 + f[20] * c2;
        if (lane < N_GRAD) inst_rows[(size_t)(b0 + rr + i) * N_GRAD + lane] = s;
      }
      bool all_done = true;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) all_done = all_done && wdone[j][k];
      next_row = b0 + rr + nr;
      tile_sync(j);  // part, wdone and the staged rows are free again
      tile_done = all_done;
    }
  }
  // rows the walk never reached: after every pixel ended, past the cut
  for (size_t q = (size_t)next_row * N_GRAD + p; q < (size_t)full_end * N_GRAD; q += PX) {
    inst_rows[q] = 0.0f;
  }
}

// One warp per Gaussian: lane c < 25 adds column c of the Gaussian's
// instance rows, in sorted-position order.
__global__ void __launch_bounds__(256)
grad_segment_sum(const float* __restrict__ inst_rows, const int* __restrict__ perm,
                 const int* __restrict__ seg, float* __restrict__ grad, int num_gauss) {
  const int g = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (g >= num_gauss || lane >= N_GRAD) return;
  float acc = 0.0f;
  const int k1 = seg[g + 1];
  for (int k = seg[g]; k < k1; ++k) acc += inst_rows[(size_t)perm[k] * N_GRAD + lane];
  grad[(size_t)g * N_GRAD + lane] = acc;
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/blend.py. Launches both
// kernels on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int radegs_blend_bwd(const void* feat, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                const void* aux, const void* med_pos, const void* perm,
                                const void* seg, void* inst_rows, void* grad, int num_tiles,
                                int tiles_x, int n_inst, int num_gauss, int width,
                                int height, int tiles_per_block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float4*>(feat);
  const auto* g = static_cast<const int*>(gauss_id);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* tc = static_cast<const int*>(tile_count);
  const auto* ax = static_cast<const float*>(aux);
  const auto* mp = static_cast<const int*>(med_pos);
  auto* rows = static_cast<float*>(inst_rows);
  const float half_w = width * 0.5f, half_h = height * 0.5f;
  if (tiles_per_block != 1 && tiles_per_block != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles > 0) {
    if (tiles_per_block == 1) {
      blend_bwd_kernel<1><<<num_tiles, PX, 0, s>>>(f, g, ts, tc, ax, mp, rows, num_tiles,
                                                   tiles_x, n_inst, half_w, half_h);
    } else {
      blend_bwd_kernel<2><<<(num_tiles + 1) / 2, 2 * PX, 0, s>>>(
          f, g, ts, tc, ax, mp, rows, num_tiles, tiles_x, n_inst, half_w, half_h);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_gauss > 0) {
    const int blocks = (int)(((size_t)num_gauss * 32 + 255) / 256);
    grad_segment_sum<<<blocks, 256, 0, s>>>(rows, static_cast<const int*>(perm),
                                            static_cast<const int*>(seg),
                                            static_cast<float*>(grad), num_gauss);
  }
  return static_cast<int>(cudaGetLastError());
}
