// Forward alpha blend of RaDe-GS on Hopper (sm_90a): per 16x16 tile, the
// front-to-back blend of the tile's depth-sorted instances into colour,
// weight, ray distance, camera coordinate, normal, median and final
// transmittance — the forward pass of renderCUDA (reference forward.cu:428-693).
//
// Replaces the TPU kernels
//   radegs_tpu/ops/pallas_blend.py:_fwd_kernel        (B1, one tile per program)
//   radegs_tpu/ops/pallas_blend_mt.py:_fwd_kernel_mt  (B3, G tiles per program)
// as ONE kernel whose template parameter G (1 or 2) is the number of tiles a
// block runs; the tiles share nothing but the block, so the two give the
// same bits. The TPU kernels' cumprod / MXU-affine reformulation is not
// carried over: each pixel walks its contributors one by one, as the
// reference does.
//
// What bounds it on an H100: instruction issue. A walked (instance, pixel)
// pair costs the gate (two deltas, the conic form rounded op by op, the exp,
// the opacity product, the 0.99 clip, the 1/255 and the T tests) and a
// blended pair ~25 more instructions; the FP32 operations are counted in
// chip_smoke.py (OPS_GATE_*, OPS_ALPHA, OPS_BLEND_*). The bytes (a 96-byte
// feature row per Gaussian, 4 per instance, 18 words written per pixel) are
// far below. The earlier kernel (one pixel a thread, 256-row rounds) issued
// ~35 instructions per walked pair and ~37 more per blended one, about 3.3
// warp instructions a clock of the SM's 4 at the training shape (its SASS):
// neither its synchronous gather nor its shared-memory loads held it back.
// What this design does about it (each choice measured against its
// alternatives by chip_smoke.py --fwd, FWD_VARIANTS, PERF.md):
//   - K = 4 pixels a thread: a tile is NT = 256 / K threads, warp w holding
//     rows 2 K w .. 2 K w + 2 K - 1 of the tile, lane l column l % 16 of
//     rows 2 q + l / 16 (q < K). The four pixels share their column, so a
//     row's gate fields, dx, a dx dx and b dx of the conic form and the dx
//     halves of the plane terms (f12 + f15 dx, ...) are loaded or computed
//     once for four pixels, and the loop's own instructions run once per row;
//     the per-pixel state stays in registers (~120, 8 tiles a SM). K = 2 and
//     K = 1 are slower;
//   - the median is followed by its index alone; its ray distance and
//     coordinate are computed once at the end from its row, by the walk's
//     own expressions (the same bits): 4 registers and 4 moves a blended
//     pixel fewer;
//   - the four gates are branch-free, the exp taken on every walked pair:
//     skipping it where alpha must stay under 1/255 (a power below
//     ln(1/255 / opacity)) saves nothing on SIMT lanes, per lane (a
//     divergent branch) or per warp (a vote), and costs its test;
//   - the rows are gathered through gauss_id by cp.async into a ring of
//     STAGES rounds of RB rows per tile, STAGES - 1 rounds ahead of the
//     walk, the indices loaded one round before their copies; one barrier a
//     round (bar.red.and on the tile's own ID), which publishes the landed
//     round, frees the oldest stage and tells the tile whether every pixel
//     has ended; a warp stops as soon as its 128 pixels have (__all_sync).
//     Early termination so stops at a warp of 128 pixels, not 32: the
//     dense view, where pixels end after a few dozen of thousands of
//     contributors, is the shape this design loses on. Skipping the gates
//     of each 32-pixel group (one pixel a lane) that has ended, through one
//     __reduce_and_sync a row, was ~10% slower at all three shapes, the
//     dense view included;
//   - the tiles run in tile order: heaviest first paid at one shape and lost
//     at the two others.
// Every skip / blend / stop decision goes through gate_power / gate_alpha /
// gate_next_t (blend_common.cuh) and the accumulation is written as in the
// plain walk, contributor by contributor in depth order: the outputs do not
// depend on K, RB, STAGES or G, and equal the earlier kernel's bit for bit;
// the backward's re-walk includes exactly the contributors the forward did.
//
// Output: out (T, 17, 256) float32, rows [0:3] colour, [3] weight, [4] ray
// distance, [5:8] coord, [8:11] normal, [11] median t, [12:15] median coord,
// [15] final T, [16] median index as a float value (the row layout of
// pallas_blend.py:28-30); med_pos (T, 256) int32, the median contributor's
// index within its tile's run, -1 for none.

#include <cstddef>

#include <cuda_runtime.h>

#include "blend_common.cuh"

using namespace radegs;

namespace {

constexpr int N_OUT = 17;
constexpr int K = 4;          // pixels per thread: 1, 2 or 4
constexpr int RB = 32;        // instances per round
constexpr int STAGES = 3;     // rounds of feature rows in the ring
constexpr int MIN_TILES = 8;  // tiles resident per SM, for __launch_bounds__

static_assert(K == 1 || K == 2 || K == 4, "K pixels per thread: 1, 2 or 4");
static_assert(STAGES >= 2, "the ring holds the round walked and one in flight");
constexpr int NT = PX / K;  // threads per tile
constexpr int SLOTS = (RB * NF4 + NT - 1) / NT;  // 16-byte copies per thread and round
constexpr unsigned FULL = 0xffffffffu;

// Round q's gathers into its ring stage: part idx % NF4 of row idx / NF4 for
// copy slot m of thread t (idx = t + m NT, its Gaussian in gid[m]); one
// commit group per round, empty or not.
__device__ __forceinline__ void issue_round(float4* ring, const float4* __restrict__ feat,
                                            const int (&gid)[SLOTS], int n, int t) {
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const int idx = t + m * NT;
    if (idx < n * NF4) copy16(ring + idx, feat + (size_t)gid[m] * NF4 + idx % NF4);
  }
  copy_commit();
}

// The Gaussians of round [b0, b0 + n)'s copies (issue_round's gid).
__device__ __forceinline__ void load_ids(int (&gid)[SLOTS], const int* __restrict__ gauss_id,
                                         int b0, int n, int t) {
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const int idx = t + m * NT;
    gid[m] = idx < n * NF4 ? __ldg(gauss_id + b0 + idx / NF4) : 0;
  }
}

template <int G>
__global__ void __launch_bounds__(G * NT, (MIN_TILES + G - 1) / G)
blend_fwd_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 float* __restrict__ out, int* __restrict__ med_pos_out, int num_tiles,
                 int tiles_x) {
  __shared__ float4 ring_all[G][STAGES * RB * NF4];

  const int j = G == 1 ? 0 : threadIdx.x / NT;  // tile of this thread within the block
  const int t = threadIdx.x - j * NT;
  const int tile = blockIdx.x * G + j;
  if (tile >= num_tiles) return;  // only this tile's threads use its barrier
  float4* ring = ring_all[j];
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int n_rounds = (count + RB - 1) / RB;

  // the first rounds' gathers go out before anything else
  int gid[SLOTS];
#pragma unroll
  for (int r = 0; r < STAGES - 1; ++r) {
    const int n = r < n_rounds ? min(RB, count - r * RB) : 0;
    load_ids(gid, gauss_id, start + r * RB, n, t);
    issue_round(ring + r * RB * NF4, feat, gid, n, t);
  }
  {
    const int r = STAGES - 1;
    load_ids(gid, gauss_id, start + r * RB, r < n_rounds ? min(RB, count - r * RB) : 0, t);
  }

  // pixel q of this thread: index w 32 K + 32 q + lane in the tile, so
  // column lane % 16 and row 2 (K w + q) + lane / 16
  const int lane = t & 31;
  const int row0 = (tile / tiles_x) * TILE + 2 * K * (t >> 5) + (lane >> 4);
  const float pix_x = (float)((tile % tiles_x) * TILE + (lane & 15));
  float pix_y[K];
  float T[K], c0[K], c1[K], c2[K], wsum[K], dist[K];
  float x0[K], x1[K], x2[K], n0[K], n1[K], n2[K];
  int med_pos[K];
  bool ended[K];  // a contributor took the pixel's T below T_EPS
#pragma unroll
  for (int q = 0; q < K; ++q) {
    pix_y[q] = (float)(row0 + 2 * q);
    T[q] = 1.0f;
    c0[q] = c1[q] = c2[q] = wsum[q] = dist[q] = 0.f;
    x0[q] = x1[q] = x2[q] = n0[q] = n1[q] = n2[q] = 0.f;
    med_pos[q] = -1;
    ended[q] = false;
  }

  for (int r = 0; r < n_rounds; ++r) {
    copy_wait<STAGES - 2>();  // this thread's copies of round r have landed
    bool all_ended = true;
#pragma unroll
    for (int q = 0; q < K; ++q) all_ended = all_ended && ended[q];
    // every thread's copies of round r; every walker done with round r - 1
    if (tile_sync_and<G, NT>(j, all_ended)) break;
    {  // the gathers of round r + STAGES - 1 go where round r - 1 was
      const int rn = r + STAGES - 1;
      const int n = rn < n_rounds ? min(RB, count - rn * RB) : 0;
      issue_round(ring + (rn % STAGES) * RB * NF4, feat, gid, n, t);
      const int rn2 = rn + 1;
      load_ids(gid, gauss_id, start + rn2 * RB, rn2 < n_rounds ? min(RB, count - rn2 * RB) : 0,
               t);
    }
    const int first = (r % STAGES) * RB;  // the round's first row in the ring
    const int n = min(RB, count - r * RB);
    for (int i = 0; i < n; ++i) {
      bool warp_ended = true;
#pragma unroll
      for (int q = 0; q < K; ++q) warp_ended = warp_ended && ended[q];
      if (__all_sync(FULL, warp_ended)) break;  // every pixel of the warp has ended
      const float4* row = &ring_all[j][(first + i) * NF4];
      const float4 f0 = row[0], f1 = row[1];
      const float g[6] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y};
      const float dx = g[0] - pix_x;
      // the K gates, branch-free, each: skipped (ended, power > 0, or alpha
      // < 1/255), ending the pixel (this contributor excluded; T stays), or
      // blended (bl)
      float alpha[K], next_T[K];
      bool bl[K], any_bl = false;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float power = gate_power(g, dx, g[1] - pix_y[q]);
        alpha[q] = gate_alpha(g[5], expf(power));
        next_T[q] = gate_next_t(T[q], alpha[q]);
        const bool cand = !ended[q] && !(power > 0.0f) && !(alpha[q] < ALPHA_EPS);
        const bool term = cand && next_T[q] < T_EPS;
        ended[q] = ended[q] || term;
        bl[q] = cand && !term;
        any_bl = any_bl || bl[q];
      }
      if (!any_bl) continue;

      const float4 f2 = row[2], f3 = row[3], f4 = row[4], f5 = row[5];
      const float f[24] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w,
                           f4.x, f4.y, f4.z, f4.w, f5.x, f5.y, f5.z, f5.w};
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (!bl[q]) continue;
        const float dy = f[1] - pix_y[q];
        const float w = alpha[q] * T[q];
        c0[q] += w * f[6];
        c1[q] += w * f[7];
        c2[q] += w * f[8];
        wsum[q] += w;
        const float t_ray = f[9] + f[10] * dx + f[11] * dy;
        dist[q] += w * t_ray;
        const float cx = f[12] + f[15] * dx + f[18] * dy;
        const float cy = f[13] + f[16] * dx + f[19] * dy;
        const float cz = f[14] + f[17] * dx + f[20] * dy;
        x0[q] += w * cx;
        x1[q] += w * cy;
        x2[q] += w * cz;
        n0[q] += w * f[21];
        n1[q] += w * f[22];
        n2[q] += w * f[23];
        // median: the last included contributor with T > 0.5
        if (T[q] > 0.5f) med_pos[q] = r * RB + i;
        T[q] = next_T[q];
      }
    }
  }
  copy_wait<0>();  // no copy may land after the block has left

#pragma unroll
  for (int q = 0; q < K; ++q) {
    // the median's ray distance and coordinate, from its row as the walk
    // computed them (the same expressions, so the same bits)
    float med_t = 0.f, m0 = 0.f, m1 = 0.f, m2 = 0.f;
    if (med_pos[q] >= 0) {
      const float* f =
          reinterpret_cast<const float*>(feat + (size_t)gauss_id[start + med_pos[q]] * NF4);
      const float dx = f[0] - pix_x;
      const float dy = f[1] - pix_y[q];
      med_t = f[9] + f[10] * dx + f[11] * dy;
      m0 = f[12] + f[15] * dx + f[18] * dy;
      m1 = f[13] + f[16] * dx + f[19] * dy;
      m2 = f[14] + f[17] * dx + f[20] * dy;
    }
    const int px = (t >> 5) * 32 * K + 32 * q + lane;
    float* o = out + (size_t)tile * N_OUT * PX + px;
    o[0 * PX] = c0[q];
    o[1 * PX] = c1[q];
    o[2 * PX] = c2[q];
    o[3 * PX] = wsum[q];
    o[4 * PX] = dist[q];
    o[5 * PX] = x0[q];
    o[6 * PX] = x1[q];
    o[7 * PX] = x2[q];
    o[8 * PX] = n0[q];
    o[9 * PX] = n1[q];
    o[10 * PX] = n2[q];
    o[11 * PX] = med_t;
    o[12 * PX] = m0;
    o[13 * PX] = m1;
    o[14 * PX] = m2;
    o[15 * PX] = T[q];
    o[16 * PX] = (float)med_pos[q];
    med_pos_out[(size_t)tile * PX + px] = med_pos[q];
  }
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/blend.py. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int radegs_blend_fwd(const void* feat, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                void* out, void* med_pos, int num_tiles, int tiles_x,
                                int tiles_per_block, void* stream) {
  if (tiles_per_block != 1 && tiles_per_block != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float4*>(feat);
  const auto* g = static_cast<const int*>(gauss_id);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* tc = static_cast<const int*>(tile_count);
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<int*>(med_pos);
  if (tiles_per_block == 1) {
    blend_fwd_kernel<1><<<num_tiles, NT, 0, s>>>(f, g, ts, tc, o, m, num_tiles, tiles_x);
  } else {
    blend_fwd_kernel<2><<<(num_tiles + 1) / 2, 2 * NT, 0, s>>>(f, g, ts, tc, o, m, num_tiles,
                                                              tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
