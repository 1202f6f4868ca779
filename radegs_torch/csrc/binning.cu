// Tile binning of a view on Hopper (sm_90a), in the 3DGS reference's design
// (rasterizer_impl.cu: duplicateWithKeys, identifyTileRanges): a count of
// each row's tiles, an exclusive scan of the counts (torch.cumsum), one
// host read of the totals, a duplicate pass that writes every kept
// (tile, row) pair's 64-bit key tile << 32 | depth-bits and its row at the
// row's scanned offset, torch.sort of the keys, and a ranges pass over the
// sorted keys. The plain version is ops/binning.py:bin_gaussians_torch,
// whose lists this gives bit for bit. Where the view's demand passes the
// instance budget, the plain version keeps the first ``budget`` slots of its
// depth-ordered expansion; the wrapper gives each row that share of its
// rect's tiles (``allow``, from a depth sort and a scan of the rows'
// ``touched``), and a second count and the duplicate pass walk only those.
//
// Replaces no TPU kernel: the JAX package bins in XLA (a cumsum, a
// searchsorted expansion of slots and a sort). Under PyTorch the same
// expansion is ~200 launches over every one of the view's 8-18M slots
// (the exact tile test alone ~70 elementwise passes) and two boolean
// indexes that each block the host.
//
// What bounds it on an H100: bytes. The count pass reads a live row's xy,
// conic and opacity (the table's first 32-byte sector), its radius and its
// flag; the duplicate pass reads them again with the depth and writes 12 B
// an instance; the ranges pass reads the sorted keys and the sort's order
// and writes 8 B an instance. The ~60 FP32 operations of a tile's exact
// test are far below. What the design does about it:
//   - one thread a row, NT rows a block; a row that is not valid reads its
//     flag alone, one with no radius its radius too;
//   - each row's tiles are walked row-major inside the thread, and a rect
//     of more than WIDE tiles by the whole warp, a lane a tile, so one
//     lane's long loop does not hold its warp's 31 others (training grows
//     such rects: a trained 1.2M view's count and duplicate kernels took
//     ~3 ms without this, ~0.2 + 0.3 ms at an untrained one); the count
//     pass keeps nothing but the row's count, the block's two totals go to
//     device memory in one atomic each, so no slot array exists before the
//     host knows its size;
//   - the instances are written in row order, so within a tile equal keys
//     (equal depths) keep the row order the plain version's stable sorts
//     give them; the plain version's depth sort of every row goes;
//   - the ranges pass writes tile_id, gauss_id (the sort's order gathered)
//     and every tile's first instance in one pass; a second, over tiles,
//     the capped counts and, in one atomic a block, the longest tile and
//     the instances the cap drops.
// Arithmetic: the plain version's float32, rounded as PyTorch's CUDA kernels
// round it, so the keep decision and the rect are its bits (one flipped
// borderline contributor moves a pixel's alpha past the check's limits):
// every product, sum, quotient and square root rounded on its own
// (__fmul_rn and friends, which the compiler never contracts into an FMA),
// `tensor / float` as a product with the float32 reciprocal PyTorch takes
// on the host (passed in), clamp as PyTorch's (NaN kept), minimum as
// torch.minimum (NaN wins), logf and floorf as PyTorch's kernels call them,
// and float-to-int conversion as its casts do.
//
// Inputs, P rows, each a pointer and element strides: xy (P, 2), radius (P,),
// depth (P,), valid (P,) bool, conic (P, 3) and opacity (P,) float32 (both
// null: the radius's square rects, no exact test), and allow (P,) int32 or
// null (no budget cut). Outputs: kept (P,) int32; touched (P,) int32 or
// null, each row's tiles before the budget and the exact test;
// counters (6,) int64 zeroed by the caller: [0] instances walked (before the
// exact test), [1] kept, [2] culled, [3] stays 0 (the budget's overflow), [4] the
// longest tile, [5] the instances max_per_tile drops; keys (N,) int64 and
// ids (N,) int32 at the rows' offsets (incl: the inclusive scan of kept);
// tile_id and gauss_id (N,) int32, bounds (T + 1,) int32 (bounds[t] the
// first instance of tile t and after), tile_count (T,) int32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
// a rect of more tiles is walked by its warp together, a lane a tile
constexpr int WIDE = 32;

// the plain version's Python floats as PyTorch hands them to a float32 kernel
constexpr float OP_MIN = static_cast<float>(1e-12);
constexpr float DET_MIN = static_cast<float>(1e-24);
constexpr float AC_MIN = static_cast<float>(1e-12);
constexpr float SLACK_MUL = static_cast<float>(1.0 + 1e-5);
constexpr float SLACK_ADD = static_cast<float>(1e-6);

struct Rows {
  const float* xy;
  const float* radius;
  const float* depth;
  const bool* valid;
  const float* conic;  // null: no exact test
  const float* opacity;
  long long xs0, xs1, rs, ds, vs, cs0, cs1, os;
};

struct Grid {
  int tiles_x, tiles_y, tile;
  float inv_tile, inv_alpha;  // float32 reciprocals of tile and of 1/255
};

// torch.clamp_min / torch.clamp with float bounds: NaN kept
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN wins
__device__ __forceinline__ float minimum_t(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.clamp(v, 0, hi).to(torch.int32)
__device__ __forceinline__ int clip_t(float v, int hi) {
  return static_cast<int>(clamp_t(v, 0.0f, static_cast<float>(hi)));
}

// a live row: its centre, conic terms and alpha threshold, and its tile rect
struct Row {
  float cx, cy, a, c, nb, tb, a_s, c_s, thr;
  int x0, y0, w, h;
};

// The plain version's row terms (bin_gaussians_torch, gaussian_rects);
// false where the row is not alive (not valid, no radius, no tile).
template <bool PRECISE>
__device__ __forceinline__ bool row_setup(const Rows& R, const Grid& G, long long i, Row& r) {
  if (!R.valid[i * R.vs]) return false;
  const float rad = R.radius[i * R.rs];
  if (!(rad > 0.0f)) return false;
  r.cx = R.xy[i * R.xs0];
  r.cy = R.xy[i * R.xs0 + R.xs1];
  float ex = rad, ey = rad;
  if constexpr (PRECISE) {
    const float* cn = R.conic + i * R.cs0;
    const float a = cn[0], b = cn[R.cs1], c = cn[2 * R.cs1];
    // tau = clamp_min(2 log(clamp_min(op, 1e-12) / (1/255)), 0)
    float t = __fmul_rn(clamp_min_t(R.opacity[i * R.os], OP_MIN), G.inv_alpha);
    const float tau = clamp_min_t(__fmul_rn(2.0f, logf(t)), 0.0f);
    const float det = clamp_min_t(__fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b)), DET_MIN);
    ex = minimum_t(__fsqrt_rn(__fdiv_rn(__fmul_rn(tau, c), det)), rad);
    ey = minimum_t(__fsqrt_rn(__fdiv_rn(__fmul_rn(tau, a), det)), rad);
    r.a = a;
    r.c = c;
    r.nb = -b;
    r.tb = __fmul_rn(2.0f, b);
    r.a_s = clamp_min_t(a, AC_MIN);
    r.c_s = clamp_min_t(c, AC_MIN);
    r.thr = __fadd_rn(__fmul_rn(tau, SLACK_MUL), SLACK_ADD);
  }
  r.x0 = clip_t(floorf(__fmul_rn(__fsub_rn(r.cx, ex), G.inv_tile)), G.tiles_x);
  r.y0 = clip_t(floorf(__fmul_rn(__fsub_rn(r.cy, ey), G.inv_tile)), G.tiles_y);
  const int x1 = clip_t(__fadd_rn(floorf(__fmul_rn(__fadd_rn(r.cx, ex), G.inv_tile)), 1.0f),
                        G.tiles_x);
  const int y1 = clip_t(__fadd_rn(floorf(__fmul_rn(__fadd_rn(r.cy, ey), G.inv_tile)), 1.0f),
                        G.tiles_y);
  r.w = max(x1 - r.x0, 0);
  r.h = max(y1 - r.y0, 0);
  return r.w * r.h > 0;
}

// Q(d) = a dx^2 + 2 b dx dy + c dy^2, summed in the plain version's order
__device__ __forceinline__ float quad(const Row& r, float dx, float dy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(r.a, dx), dx),
                             __fmul_rn(__fmul_rn(r.tb, dx), dy)),
                   __fmul_rn(__fmul_rn(r.c, dy), dy));
}

// The exact tile test (_q_min_over_rect): min of Q over the tile's pixel
// rect, 0 with the centre inside, against tau's slackened threshold.
__device__ __forceinline__ bool keep_tile(const Row& r, const Grid& G, int tx, int ty) {
  const float x0 = static_cast<float>(tx * G.tile), y0 = static_cast<float>(ty * G.tile);
  const float span = static_cast<float>(G.tile - 1);
  const float dx0 = __fsub_rn(x0, r.cx), dx1 = __fsub_rn(__fadd_rn(x0, span), r.cx);
  const float dy0 = __fsub_rn(y0, r.cy), dy1 = __fsub_rn(__fadd_rn(y0, span), r.cy);
  const float ex0 = quad(r, dx0, clamp_t(__fdiv_rn(__fmul_rn(r.nb, dx0), r.c_s), dy0, dy1));
  const float ex1 = quad(r, dx1, clamp_t(__fdiv_rn(__fmul_rn(r.nb, dx1), r.c_s), dy0, dy1));
  const float ey0 = quad(r, clamp_t(__fdiv_rn(__fmul_rn(r.nb, dy0), r.a_s), dx0, dx1), dy0);
  const float ey1 = quad(r, clamp_t(__fdiv_rn(__fmul_rn(r.nb, dy1), r.a_s), dx0, dx1), dy1);
  const float qmin = minimum_t(minimum_t(ex0, ex1), minimum_t(ey0, ey1));
  const bool inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
  return (inside ? 0.0f : qmin) <= r.thr;
}

// the sum (MAX: the largest) of v over the block, in thread 0
template <bool MAX>
__device__ __forceinline__ unsigned long long block_reduce(unsigned long long v,
                                                           unsigned long long* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_down_sync(FULL, v, o);
    v = MAX ? max(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < WARPS; ++k) v = MAX ? max(v, shared[k]) : v + shared[k];
  }
  return v;
}

// row ``src``'s terms in every lane of the warp
__device__ __forceinline__ Row shfl_row(const Row& r, int src) {
  Row s;
  s.cx = __shfl_sync(FULL, r.cx, src);
  s.cy = __shfl_sync(FULL, r.cy, src);
  s.a = __shfl_sync(FULL, r.a, src);
  s.c = __shfl_sync(FULL, r.c, src);
  s.nb = __shfl_sync(FULL, r.nb, src);
  s.tb = __shfl_sync(FULL, r.tb, src);
  s.a_s = __shfl_sync(FULL, r.a_s, src);
  s.c_s = __shfl_sync(FULL, r.c_s, src);
  s.thr = __shfl_sync(FULL, r.thr, src);
  s.x0 = __shfl_sync(FULL, r.x0, src);
  s.y0 = __shfl_sync(FULL, r.y0, src);
  s.w = __shfl_sync(FULL, r.w, src);
  s.h = __shfl_sync(FULL, r.h, src);
  return s;
}

// The tiles a row walks, row-major from its rect's first: all ``touched``,
// or where the instance budget cuts, the first ``allow[i]`` of them.
__device__ __forceinline__ int walked(const int* allow, long long i, int touched) {
  return allow != nullptr ? min(allow[i], touched) : touched;
}

template <bool PRECISE>
__global__ void __launch_bounds__(NT)
binning_count_kernel(const Rows R, const Grid G, int P, const int* allow, int* touched_out,
                     int* kept, unsigned long long* counters) {
  __shared__ unsigned long long red[2][WARPS];
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int touched = 0, lim = 0, n = 0;
  Row r{};
  if (i < P && row_setup<PRECISE>(R, G, i, r)) {
    touched = r.w * r.h;
    lim = walked(allow, i, touched);
    if (!PRECISE) {
      n = lim;
    } else if (lim <= WIDE) {
      int tx = r.x0, ty = r.y0;
      for (int j = 0; j < lim; ++j) {
        n += keep_tile(r, G, tx, ty);
        if (++tx == r.x0 + r.w) {
          tx = r.x0;
          ++ty;
        }
      }
    }
  }
  if constexpr (PRECISE) {  // the warp tests each wide rect's tiles together
    for (unsigned wide = __ballot_sync(FULL, lim > WIDE); wide; wide &= wide - 1) {
      const int src = __ffs(wide) - 1;
      const Row s = shfl_row(r, src);
      const int s_lim = __shfl_sync(FULL, lim, src);
      int c = 0;
      for (int j = lane; j < s_lim; j += 32) c += keep_tile(s, G, s.x0 + j % s.w, s.y0 + j / s.w);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
      if (lane == src) n = c;
    }
  }
  if (i < P) {
    kept[i] = n;
    if (touched_out != nullptr) touched_out[i] = touched;
  }
  const unsigned long long all = block_reduce<false>(lim, red[0]);
  const unsigned long long kept_sum = block_reduce<false>(n, red[1]);
  if (threadIdx.x == 0) {
    if (all) atomicAdd(&counters[0], all);
    if (kept_sum) atomicAdd(&counters[1], kept_sum);
    if (all != kept_sum) atomicAdd(&counters[2], all - kept_sum);
  }
}

template <bool PRECISE>
__global__ void __launch_bounds__(NT)
binning_duplicate_kernel(const Rows R, const Grid G, int P, const int* allow, const int* kept,
                         const int* incl, long long* keys, int* ids) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int n = i < P ? kept[i] : 0;
  Row r{};
  long long at = 0, low = 0;
  int lim = 0;
  if (n > 0) {
    row_setup<PRECISE>(R, G, i, r);
    lim = walked(allow, i, r.w * r.h);
    // _depth_bits: float32 -> [0, 2^32) in the same order, -0.0 as 0.0
    const long long bits = __float_as_int(__fadd_rn(R.depth[i * R.ds], 0.0f));
    low = (bits >= 0 ? bits : (bits ^ 0x7FFFFFFFLL)) + (1LL << 31);
    at = static_cast<long long>(incl[i]) - n;
  }
  if (n > 0 && lim <= WIDE) {
    int tx = r.x0, ty = r.y0;
    for (int j = 0; j < lim; ++j) {
      bool k = true;
      if constexpr (PRECISE) k = keep_tile(r, G, tx, ty);
      if (k) {
        keys[at] = (static_cast<long long>(ty) * G.tiles_x + tx) << 32 | low;
        ids[at] = static_cast<int>(i);
        ++at;
      }
      if (++tx == r.x0 + r.w) {
        tx = r.x0;
        ++ty;
      }
    }
  }
  // the warp writes each wide rect's kept tiles together, in the same
  // row-major order, each lane's at its rank among the kept of its round
  for (unsigned wide = __ballot_sync(FULL, n > 0 && lim > WIDE); wide; wide &= wide - 1) {
    const int src = __ffs(wide) - 1;
    const Row s = shfl_row(r, src);
    const int s_lim = __shfl_sync(FULL, lim, src);
    long long s_at = __shfl_sync(FULL, at, src);
    const long long s_low = __shfl_sync(FULL, low, src);
    const int row = static_cast<int>(i - lane + src);
    for (int j0 = 0; j0 < s_lim; j0 += 32) {
      const int j = j0 + lane;
      const int tx = s.x0 + j % s.w, ty = s.y0 + j / s.w;
      bool k = j < s_lim;
      if constexpr (PRECISE) k = k && keep_tile(s, G, tx, ty);
      const unsigned m = __ballot_sync(FULL, k);
      if (k) {
        const long long pos = s_at + __popc(m & ((1u << lane) - 1));
        keys[pos] = (static_cast<long long>(ty) * G.tiles_x + tx) << 32 | s_low;
        ids[pos] = row;
      }
      s_at += __popc(m);
    }
  }
}

// over instances 0..n (n itself closes the last tiles): tile_id, gauss_id
// and the first instance of every tile from the one before it
__global__ void __launch_bounds__(NT)
binning_bounds_kernel(const long long* skeys, const long long* order, const int* ids, int n,
                      int T, int* tile_id, int* gauss_id, int* bounds) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i > n) return;
  const int cur = i < n ? static_cast<int>(skeys[i] >> 32) : T;
  const int prev = i > 0 ? static_cast<int>(skeys[i - 1] >> 32) : -1;
  if (i < n) {
    tile_id[i] = cur;
    gauss_id[i] = ids[order[i]];
  }
  for (int t = prev + 1; t <= cur; ++t) bounds[t] = static_cast<int>(i);
}

__global__ void __launch_bounds__(NT)
binning_ranges_kernel(const int* bounds, int T, int max_per_tile, int* tile_count,
                      unsigned long long* counters) {
  __shared__ unsigned long long red[2][WARPS];
  const int t = blockIdx.x * NT + threadIdx.x;
  unsigned long long full = 0, cut = 0;
  if (t < T) {
    const int f = bounds[t + 1] - bounds[t];
    const int c = min(f, max_per_tile);
    tile_count[t] = c;
    full = f;
    cut = f - c;
  }
  const unsigned long long longest = block_reduce<true>(full, red[0]);
  const unsigned long long dropped = block_reduce<false>(cut, red[1]);
  if (threadIdx.x == 0) {
    if (longest) atomicMax(&counters[4], longest);
    if (dropped) atomicAdd(&counters[5], dropped);
  }
}

unsigned blocks_of(long long n) { return static_cast<unsigned>((n + NT - 1) / NT); }

}  // namespace

// One stage of the binning, launched on ``stream``:
//   0 count:     rows, allow -> kept, touched, counters[0..2]
//   1 duplicate: rows, allow, kept, incl -> keys, ids (n instances)
//   2 ranges:    sorted keys, order, ids -> tile_id, gauss_id, bounds,
//                tile_count, counters[4..5]
// ``ptrs`` is a table of 19 pointers: xy, radius, depth, valid, conic,
// opacity, kept, incl, counters, keys, ids, sorted keys, order, tile_id,
// gauss_id, bounds, tile_count, touched, allow (a stage reads only its own;
// touched and allow may be null). Returns the
// launch's cudaError_t.
extern "C" int radegs_binning(const void* ptrs, int stage, int P, int n, int xs0, int xs1,
                              int rs, int ds, int vs, int cs0, int cs1, int os, int tiles_x,
                              int tiles_y, int tile, int max_per_tile, float inv_tile,
                              float inv_alpha, void* stream) {
  const void* const* p = static_cast<const void* const*>(ptrs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 0 || n < 0 || tiles_x < 0 || tiles_y < 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows R{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
         static_cast<const float*>(p[2]), static_cast<const bool*>(p[3]),
         static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
         xs0, xs1, rs, ds, vs, cs0, cs1, os};
  const Grid G{tiles_x, tiles_y, tile, inv_tile, inv_alpha};
  const bool precise = R.conic != nullptr && R.opacity != nullptr;
  auto* counters = static_cast<unsigned long long*>(const_cast<void*>(p[8]));
  int* kept = static_cast<int*>(const_cast<void*>(p[6]));
  const int* allow = static_cast<const int*>(p[18]);
  if (stage == 0) {
    if (P == 0) return 0;
    int* touched = static_cast<int*>(const_cast<void*>(p[17]));
    if (precise) {
      binning_count_kernel<true><<<blocks_of(P), NT, 0, s>>>(R, G, P, allow, touched, kept,
                                                              counters);
    } else {
      binning_count_kernel<false><<<blocks_of(P), NT, 0, s>>>(R, G, P, allow, touched, kept,
                                                               counters);
    }
  } else if (stage == 1) {
    if (P == 0 || n == 0) return 0;
    const int* incl = static_cast<const int*>(p[7]);
    auto* keys = static_cast<long long*>(const_cast<void*>(p[9]));
    int* ids = static_cast<int*>(const_cast<void*>(p[10]));
    if (precise) {
      binning_duplicate_kernel<true><<<blocks_of(P), NT, 0, s>>>(R, G, P, allow, kept, incl,
                                                                  keys, ids);
    } else {
      binning_duplicate_kernel<false><<<blocks_of(P), NT, 0, s>>>(R, G, P, allow, kept, incl,
                                                                   keys, ids);
    }
  } else if (stage == 2) {
    const int T = tiles_x * tiles_y;
    int* bounds = static_cast<int*>(const_cast<void*>(p[15]));
    binning_bounds_kernel<<<blocks_of(static_cast<long long>(n) + 1), NT, 0, s>>>(
        static_cast<const long long*>(p[11]), static_cast<const long long*>(p[12]),
        static_cast<const int*>(p[10]), n, T, static_cast<int*>(const_cast<void*>(p[13])),
        static_cast<int*>(const_cast<void*>(p[14])), bounds);
    if (T > 0) {
      binning_ranges_kernel<<<blocks_of(T), NT, 0, s>>>(
          bounds, T, max_per_tile, static_cast<int*>(const_cast<void*>(p[16])), counters);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
