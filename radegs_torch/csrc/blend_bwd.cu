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
//   1. blend_bwd_kernel<G>: G tiles per block (1 or 2, bit-identical: the
//      tiles share nothing but the block), NT = 256 / K threads per tile,
//      each walking K pixels. A pixel walks its contributors with the
//      forward's gates (blend_common.cuh), carrying its transmittance T and
//      ONE prefix scalar sum(w dL/dw): the cotangents are constant along a
//      pixel's walk, so "everything behind me" is (s_tot + g_tf T_final) -
//      prefix, with s_tot = sum over channels of cotangent x forward total
//      (the identity of pallas_blend.py:738-743). Each contributor's 25
//      pixel sums are added in a fixed order (a thread's own pixels in
//      registers, then the warp's shuffle tree, then the tile's warps in
//      warp order) into one row, written where the wrapper's stable sort of
//      gauss_id puts the instance (``rank``): each Gaussian's rows lie
//      together, in sorted-position order. Rows the walk never reaches
//      (after every pixel of the tile ended, or past the max_per_tile cut)
//      are written as zeros.
//   2. grad_segment_sum: one warp per Gaussian adds its rows in that order,
//      then the ray-plane and camera-plane terms of d(xy), which are linear
//      in the summed rows and constant per Gaussian, and stores each sum at
//      its column of the per-Gaussian table (the gradient of the table the
//      preprocess wrote) with xy_abs after it, so the preprocess backward
//      reads the buffer as it stands.
// No atomics: two runs, and G = 1 against G = 2, give the same bits.
//
// What bounds it on an H100: FP32 operations. A walked (instance, pixel)
// pair costs the forward's gate (~19 operations); a blended pair ~125 more
// (the gradient terms, and the 25 sums the reduction adds it into; the count
// is itemised in chip_smoke.py). The bytes are the forward's (a 96-byte
// feature row per Gaussian, 4 per instance), 29 words of cotangents, totals
// and median index per pixel, and the 100-byte instance rows written once
// and read once. The earlier kernel (one pixel a thread) spent its time on
// the warp reduction (a 32-value shuffle reduce-scatter per warp and
// instance, 8 warps a tile), two barriers per 16 instances behind exposed
// gathers, 16 named barriers reserved per block, and a segment sum that
// gathered each Gaussian's rows from all over the sorted list. What this
// design does about it (each choice measured against its alternatives by
// chip_smoke.py's BWD_VARIANTS, PERF.md):
//   - K = 4 pixels a thread, an 8 x 8 quadrant of the tile each (a warp
//     covers 8 x 4 pixels of each quadrant): the four gates of an instance
//     are independent and branch-free, a thread adds its own blended
//     pixels' 25 terms in registers, and one warp reduction covers 128
//     pixels; a tile is 2 warps, not 8. K = 2 spills and is slower;
//   - the per-pixel cotangents live in shared memory as 16-word records
//     (3 float4 read per blended pixel; the median's 4 words only by the
//     median contributor), T, the prefix and the median index in
//     registers; 128 registers and 22 KB of shared memory a tile let 8
//     tiles (16 warps) share an SM without spilling;
//   - feature rows are gathered through gauss_id by cp.async (16 bytes a
//     copy) into a ring of STAGES rounds of RB rows, STAGES - 1 rounds
//     ahead of the walk, the indices loaded one round before their copies;
//     one barrier per round (bar.red.and on an immediate ID, which also
//     tells the tile whether all its pixels ended) publishes the landed
//     rows and the previous round's warp partials, which the whole tile
//     then sums and writes;
//   - the segment sum streams each Gaussian's contiguous rows (32 floats,
//     full sectors), SEG_BATCH rows in flight per warp;
//   - a tile stops walking when all its pixels have ended (T < 1e-4).
//
// Inputs: feat (P, 24) float32, the per-Gaussian table (blend_common.cuh
// layout), gauss_id (N,), tile_start / tile_count (T,), aux (T, 28, 256)
// float32 cotangents and forward totals (layout in
// radegs_torch/ops/blend.py:pack_aux), med_pos (T, 256) int32, rank / seg
// (radegs_torch/ops/blend.py:instance_segments).
// Output: grad (P, 26) float32: columns 0:24 the gradient of the table in
// its own column order, 24 xy_abs, 25 zero; inst_rows (N, ROW) is scratch,
// each row in the lane order of pallas_blend.py:579-581 (grad_column).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "blend_common.cuh"

using namespace radegs;

namespace {

constexpr int N_GRAD = 25;     // sums per instance row
constexpr int GRAD_COLS = 26;  // a Gaussian's gradient: the table's 24 columns, xy_abs, 0
constexpr int N_AUX = 28;
constexpr int K = 4;        // pixels per thread: 2, 4 or 8
constexpr int RB = 8;       // instances per round
constexpr int STAGES = 3;   // rounds of feature rows in the ring
constexpr int MIN_TILES = 8;  // tiles resident per SM, for __launch_bounds__
constexpr int SEG_BATCH = 16;  // rows in flight per warp in the segment sum
constexpr int ROW = 32;       // floats per instance row (25 used)
constexpr unsigned FULL = 0xffffffffu;

static_assert(K == 2 || K == 4 || K == 8, "K pixels per thread: 2, 4 or 8");
static_assert(RB >= 1 && RB <= 32, "a round's instances are bits of one mask");
static_assert(STAGES >= 2, "the ring holds the round walked and one in flight");
static_assert(ROW >= N_GRAD && ROW <= 32, "an instance row is one warp's width at most");
constexpr int NT = PX / K;         // threads per tile
constexpr int NW = NT / 32;        // warps per tile
constexpr int ROWS_Y = 32 / K;     // pixel rows of a thread's 8-wide block
constexpr int REC = 16;            // words of a pixel's cotangent record
constexpr int SLOTS = (RB * NF4 + NT - 1) / NT;  // row copies per thread and round
constexpr unsigned DONE_ALL = (1u << K) - 1;

// shared memory of one tile, in floats: cotangent records, the feature-row
// ring, two rounds of warp partials and their masks
constexpr int OFF_RING = PX * REC;
constexpr int OFF_PART = OFF_RING + STAGES * RB * NF4 * 4;
constexpr int OFF_MASK = OFF_PART + 2 * RB * NW * N_GRAD;
constexpr int TILE_FLOATS = (OFF_MASK + 2 * NW + 3) / 4 * 4;
constexpr int TILE_BYTES = TILE_FLOATS * 4;

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

// The gathered rows of one round: row i of [b0, b0 + n) lands at ring[i * NF4].
// Copy slot m of this thread is idx = t + m * NT (row idx / NF4, part idx % NF4);
// gid[m] holds its Gaussian, loaded one round earlier.
__device__ __forceinline__ void issue_round(float4* ring, const float4* __restrict__ feat,
                                            const int (&gid)[SLOTS], int n, int t) {
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    const int idx = t + m * NT;
    if (idx < n * NF4) copy16(ring + idx, feat + (size_t)gid[m] * NF4 + idx % NF4);
  }
  copy_commit();
}

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
blend_bwd_kernel(const float4* __restrict__ feat, const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 const float* __restrict__ aux, const int* __restrict__ med_pos,
                 const int* __restrict__ rank, float* __restrict__ inst_rows, int num_tiles,
                 int tiles_x, int n_inst, float half_w, float half_h) {
  extern __shared__ float4 smem4[];
  const int j = threadIdx.x / NT;  // tile of this thread within the block
  const int t = threadIdx.x - j * NT;
  const int lane = t & 31;
  const int w = t >> 5;
  const int tile = blockIdx.x * G + j;
  if (tile >= num_tiles) return;  // only this tile's threads use its barrier

  float* sm = reinterpret_cast<float*>(smem4) + (size_t)j * TILE_FLOATS;
  float4* cot = reinterpret_cast<float4*>(sm);  // record of (q, t): cot[(q * NT + t) * 5 ..]
  float4* ring = reinterpret_cast<float4*>(sm + OFF_RING);
  float* part = sm + OFF_PART;  // [2][RB][NW][25]
  unsigned* pmask = reinterpret_cast<unsigned*>(sm + OFF_MASK);  // [2][NW]

  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int end = start + count;
  // the tile's rows in the sorted list, including those past the cut
  const int full_end = tile + 1 < num_tiles ? tile_start[tile + 1] : n_inst;
  const int n_rounds = (count + RB - 1) / RB;

  // the first rounds' gathers go out before the cotangents are read
  int gid[SLOTS];
#pragma unroll
  for (int r = 0; r < STAGES - 1; ++r) {
    const int b0 = start + r * RB;
    const int n = r < n_rounds ? min(RB, end - b0) : 0;
    load_ids(gid, gauss_id, b0, n, t);
    issue_round(ring + (r % STAGES) * RB * NF4, feat, gid, n, t);
  }
  {
    const int r = STAGES - 1;
    const int b0 = start + r * RB;
    load_ids(gid, gauss_id, b0, r < n_rounds ? min(RB, end - b0) : 0, t);
  }

  // pixel q of this thread: column 8 (q % 2) + t % 8, row ROWS_Y (q / 2) + t / 8
  const float bx = (float)((tile % tiles_x) * TILE + (t & 7));
  const float by = (float)((tile / tiles_x) * TILE + (t >> 3));
  const float* a0 = aux + (size_t)tile * N_AUX * PX;
  int mp[K];  // the median contributor's index in the run, per pixel
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int p = (ROWS_Y * (q >> 1) + (t >> 3)) * TILE + 8 * (q & 1) + (t & 7);
    const float* a = a0 + p;
    const float gw = a[3 * PX], gd = a[4 * PX];
    float s_tot = gw * a[19 * PX] + gd * a[20 * PX];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_tot = s_tot + a[k * PX] * a[(16 + k) * PX] + a[(8 + k) * PX] * a[(24 + k) * PX] +
              a[(5 + k) * PX] * a[(21 + k) * PX];
    }
    // what every blended pixel reads, then the median's cotangents; the
    // totals enter only as s_tot + g_tf T_final
    float4* rec = cot + (q * NT + t) * (REC / 4);
    rec[0] = make_float4(a[0], a[PX], a[2 * PX], gw);
    rec[1] = make_float4(gd, a[5 * PX], a[6 * PX], a[7 * PX]);
    rec[2] = make_float4(a[8 * PX], a[9 * PX], a[10 * PX], s_tot + a[11 * PX] * a[27 * PX]);
    rec[3] = make_float4(a[12 * PX], a[13 * PX], a[14 * PX], a[15 * PX]);
    mp[q] = med_pos[(size_t)tile * PX + p];
  }

  float T[K], pre[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    T[q] = 1.0f;
    pre[q] = 0.0f;
  }
  unsigned done = 0;  // bit q: pixel q has ended
  int r = 0;
  for (;; ++r) {
    copy_wait<STAGES - 2>();  // this thread's copies of round r have landed
    // every thread's copies of round r, and the partials of round r - 1
    const bool all_done = tile_sync_and<G, NT>(j, done == DONE_ALL);
    if (r > 0) {
      // the rows of round r - 1: the tile's warp partials in warp order
      const int b0 = start + (r - 1) * RB;
      const int n = min(RB, end - b0);
      const float* pp = part + ((r - 1) & 1) * RB * NW * N_GRAD;
      const unsigned* pm = pmask + ((r - 1) & 1) * NW;
      for (int idx = t; idx < n * ROW; idx += NT) {
        const int i = idx / ROW;
        const int c = idx - i * ROW;
        float s = 0.0f;
        if (c < N_GRAD) {
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            if (pm[k] >> i & 1) s += pp[(i * NW + k) * N_GRAD + c];
          }
        }
        inst_rows[(size_t)__ldg(rank + b0 + i) * ROW + c] = s;
      }
    }
    if (r == n_rounds || all_done) break;

    // the gathers of round r + STAGES - 1 go where round r - 1 was
    {
      const int rn = r + STAGES - 1;
      const int b0 = start + rn * RB;
      const int n = rn < n_rounds ? min(RB, end - b0) : 0;
      issue_round(ring + (rn % STAGES) * RB * NF4, feat, gid, n, t);
      const int rn2 = rn + 1;
      const int b2 = start + rn2 * RB;
      load_ids(gid, gauss_id, b2, rn2 < n_rounds ? min(RB, end - b2) : 0, t);
    }

    const int b0 = start + r * RB;
    const int n = min(RB, end - b0);
    const float4* rows = ring + (r % STAGES) * RB * NF4;
    float* pp = part + (r & 1) * RB * NW * N_GRAD;
    unsigned wmask = 0;  // bit i: this warp blended instance i
    for (int i = 0; i < n; ++i) {
      const float4* row = rows + i * NF4;
      const float4 f0 = row[0], f1 = row[1];
      const float g[6] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y};
      // the gates of the K pixels, independent of each other and without
      // branches (the falloff of a skipped contributor is never used)
      unsigned bl = 0;  // bit q: pixel q blends this contributor
      float fall[K], alpha[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float dx = g[0] - (bx + 8.0f * (q & 1));
        const float dy = g[1] - (by + (float)(ROWS_Y * (q >> 1)));
        const float power = gate_power(g, dx, dy);
        fall[q] = expf(fminf(power, 0.0f));
        alpha[q] = gate_alpha(g[5], fall[q]);
        const bool cand = !(done >> q & 1) && power <= 0.0f && alpha[q] >= ALPHA_EPS;
        // a contributor that would take T below T_EPS is excluded and ends the pixel
        const bool term = cand && gate_next_t(T[q], alpha[q]) < T_EPS;
        done |= (unsigned)term << q;
        bl |= (unsigned)(cand && !term) << q;
      }
      const unsigned wb = __ballot_sync(FULL, bl != 0);
      if (wb == 0) continue;  // warp-uniform: no lane blends this contributor

      const float4 f2 = row[2], f3 = row[3], f4 = row[4], f5 = row[5];
      const float f[24] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w,
                           f4.x, f4.y, f4.z, f4.w, f5.x, f5.y, f5.z, f5.w};
      const int pos = b0 + i - start;  // the contributor's index in the tile's run
      float acc[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (!(bl >> q & 1)) continue;
        const float4* rec = cot + (q * NT + t) * (REC / 4);
        const float4 c0 = rec[0], c1 = rec[1], c2 = rec[2];
        const float gc[3] = {c0.x, c0.y, c0.z}, gx[3] = {c1.y, c1.z, c1.w};
        const float gn[3] = {c2.x, c2.y, c2.z};
        const float gw = c0.w, gd = c1.x, s_all = c2.w;
        const float dx = f[0] - (bx + 8.0f * (q & 1));
        const float dy = f[1] - (by + (float)(ROWS_Y * (q >> 1)));
        const float fl = fall[q], al = alpha[q], Tq = T[q];
        const float wt = al * Tq;
        const float t_ray = f[9] + f[10] * dx + f[11] * dy;
        const float cx = f[12] + f[15] * dx + f[18] * dy;
        const float cy = f[13] + f[16] * dx + f[19] * dy;
        const float cz = f[14] + f[17] * dx + f[20] * dy;
        // dL/dw: the direct path through this contributor's weight
        const float dL_dw = gc[0] * f[6] + gc[1] * f[7] + gc[2] * f[8] + gn[0] * f[21] +
                            gn[1] * f[22] + gn[2] * f[23] + gw + gd * t_ray + gx[0] * cx +
                            gx[1] * cy + gx[2] * cz;
        pre[q] += wt * dL_dw;  // inclusive prefix
        const float suffix = s_all - pre[q];
        const float dL_dalpha = Tq * dL_dw - suffix / (1.0f - al);
        // median routing (backward.cu:909-936); its cotangents are read
        // only by the one contributor that is the pixel's median
        float gmt = 0.0f, gmx[3] = {0.0f, 0.0f, 0.0f};
        if (pos == mp[q]) {
          const float4 c3 = rec[3];
          gmt = c3.x;
          gmx[0] = c3.y;
          gmx[1] = c3.z;
          gmx[2] = c3.w;
        }
        const float dL_dt = wt * gd + gmt;
        const float d0 = wt * gx[0] + gmx[0];
        const float d1 = wt * gx[1] + gmx[1];
        const float d2 = wt * gx[2] + gmx[2];
        // alpha -> (opacity, falloff) through the 0.99 clip gate
        const float dL_draw = f[5] * fl < MAX_ALPHA ? dL_dalpha : 0.0f;
        const float dL_dG = dL_draw * f[5];
        const float gdx = fl * dx, gdy = fl * dy;
        const float e_x = dL_dG * (-gdx * f[2] - gdy * f[3]);
        const float e_y = dL_dG * (-gdy * f[4] - gdx * f[3]);
        acc[0] += e_x;
        acc[1] += e_y;
        acc[2] += fabsf(e_x) * half_w + fabsf(e_y) * half_h;
        acc[3] += -0.5f * gdx * dx * dL_dG;
        acc[4] += -gdx * dy * dL_dG;  // the off-diagonal appears twice in power
        acc[5] += -0.5f * gdy * dy * dL_dG;
        acc[6] += dL_draw * fl;
        acc[7] += wt * gc[0];
        acc[8] += wt * gc[1];
        acc[9] += wt * gc[2];
        acc[10] += d0;
        acc[11] += d1;
        acc[12] += d2;
        acc[13] += d0 * dx;
        acc[14] += d1 * dx;
        acc[15] += d2 * dx;
        acc[16] += d0 * dy;
        acc[17] += d1 * dy;
        acc[18] += d2 * dy;
        acc[19] += dL_dt * dx;
        acc[20] += dL_dt * dy;
        acc[21] += wt * gn[0];
        acc[22] += wt * gn[1];
        acc[23] += wt * gn[2];
        acc[24] += dL_dt;
        T[q] = gate_next_t(Tq, al);
      }

      // the warp's sum of each of the 25 values, in lane c
      const float s = warp_reduce_scatter(acc, lane);
      if (lane < N_GRAD) pp[(i * NW + w) * N_GRAD + lane] = s;
      wmask |= 1u << i;
    }
    if (lane == 0) pmask[(r & 1) * NW + w] = wmask;
  }
  copy_wait<0>();  // no copy may land after the block has left

  // rows the walk never reached: after every pixel ended, past the cut
  const int next_row = start + min(r * RB, count);
  for (int q = t; q < (full_end - next_row) * ROW; q += NT) {
    const int b = next_row + q / ROW;
    inst_rows[(size_t)__ldg(rank + b) * ROW + q % ROW] = 0.0f;
  }
}

// The gradient buffer's column of lane c's sum (the instance rows' order,
// pallas_blend.py:579-581: xy, xy_abs, conic, opacity, rgb, view_point,
// camera_plane x, camera_plane y, ray_plane, normal, ts): the table's column
// (blend_common.cuh), xy_abs at 24, lane 25 the zero at 25.
__device__ __forceinline__ int grad_column(int c) {
  if (c < 2) return c;        // xy
  if (c == 2) return 24;      // xy_abs
  if (c < 10) return c - 1;   // conic, opacity, rgb: 2:9
  if (c < 19) return c + 2;   // view_point, camera_plane: 12:21
  if (c < 21) return c - 9;   // ray_plane: 10:12
  if (c < 24) return c;       // normal
  return c == 24 ? 9 : c;     // ts; 25
}

// One warp per Gaussian: lane c < 25 adds column c of the Gaussian's
// instance rows, which lie together in sorted-position order (SEG_BATCH
// rows loaded at once; lanes past ROW read nothing, so a buffer of exactly
// (N, ROW) floats is enough), then lanes 0 and 1 add the ray-plane and
// camera-plane terms of d(xy): f[10] s_t + f[15] c0 + f[16] c1 + f[17] c2
// (and f[11], f[18..20]) with s_t the summed dL/dt (column 24) and c the
// summed dL/dcoord (10..12); lane c < 26 stores at grad_column(c).
__global__ void __launch_bounds__(256)
grad_segment_sum(const float* __restrict__ inst_rows, const int* __restrict__ seg,
                 const float* __restrict__ feat, float* __restrict__ grad, int num_gauss) {
  const int g = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (g >= num_gauss) return;  // warp-uniform
  const int k0 = seg[g], k1 = seg[g + 1];
  const float* col = inst_rows + lane;
  float acc = 0.0f;
  if (lane < ROW) {
    int k = k0;
    for (; k + SEG_BATCH <= k1; k += SEG_BATCH) {
      float v[SEG_BATCH];
#pragma unroll
      for (int u = 0; u < SEG_BATCH; ++u) v[u] = col[(size_t)(k + u) * ROW];
#pragma unroll
      for (int u = 0; u < SEG_BATCH; ++u) acc += v[u];
    }
    for (; k < k1; ++k) acc += col[(size_t)k * ROW];
  }
  const float s_t = __shfl_sync(FULL, acc, 24);
  const float c0 = __shfl_sync(FULL, acc, 10);
  const float c1 = __shfl_sync(FULL, acc, 11);
  const float c2 = __shfl_sync(FULL, acc, 12);
  if (k1 > k0 && lane < 2) {
    const float* f = feat + (size_t)g * NF4 * 4;
    acc += lane == 0 ? f[10] * s_t + f[15] * c0 + f[16] * c1 + f[17] * c2
                     : f[11] * s_t + f[18] * c0 + f[19] * c1 + f[20] * c2;
  }
  if (lane < GRAD_COLS) {
    grad[(size_t)g * GRAD_COLS + grad_column(lane)] = lane < N_GRAD ? acc : 0.f;
  }
}

// The tiles' shared memory exceeds the default 48 KB at G = 2: allow it
// once per device and instantiation.
template <int G>
cudaError_t allow_smem() {
  static uint64_t allowed = 0;  // bit d: device d done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (allowed >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(blend_bwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G * TILE_BYTES);
  if (err == cudaSuccess && dev < 64) allowed |= uint64_t{1} << dev;
  return err;
}

template <int G>
cudaError_t launch_walk(const float4* f, const int* g, const int* ts, const int* tc,
                        const float* ax, const int* mp, const int* rank, float* rows,
                        int num_tiles, int tiles_x, int n_inst, float half_w, float half_h,
                        cudaStream_t s) {
  const cudaError_t err = allow_smem<G>();
  if (err != cudaSuccess) return err;
  blend_bwd_kernel<G><<<(num_tiles + G - 1) / G, G * NT, G * TILE_BYTES, s>>>(
      f, g, ts, tc, ax, mp, rank, rows, num_tiles, tiles_x, n_inst, half_w, half_h);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/blend.py. Launches both
// kernels on `stream` (the walk when num_tiles > 0, the segment sum when
// num_gauss > 0) and returns cudaGetLastError() (0 on success). rank (N,)
// gives each instance's row in Gaussian order (the inverse of the stable
// sort of gauss_id), seg (P + 1,) each Gaussian's first row; inst_rows is
// (N, ROW) float32 scratch; grad is (P, GRAD_COLS) float32.
extern "C" int radegs_blend_bwd(const void* feat, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                const void* aux, const void* med_pos, const void* rank,
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
  const auto* rk = static_cast<const int*>(rank);
  auto* rows = static_cast<float*>(inst_rows);
  const float half_w = width * 0.5f, half_h = height * 0.5f;
  if (tiles_per_block != 1 && tiles_per_block != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles > 0) {
    const cudaError_t err =
        tiles_per_block == 1
            ? launch_walk<1>(f, g, ts, tc, ax, mp, rk, rows, num_tiles, tiles_x, n_inst,
                             half_w, half_h, s)
            : launch_walk<2>(f, g, ts, tc, ax, mp, rk, rows, num_tiles, tiles_x, n_inst,
                             half_w, half_h, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_gauss > 0) {
    const int blocks = (int)(((size_t)num_gauss * 32 + 255) / 256);
    grad_segment_sum<<<blocks, 256, 0, s>>>(rows, static_cast<const int*>(seg),
                                            static_cast<const float*>(feat),
                                            static_cast<float*>(grad), num_gauss);
  }
  return static_cast<int>(cudaGetLastError());
}
