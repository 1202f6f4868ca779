// Adam and the densification statistics of a train step on Hopper (sm_90a),
// in one launch: the update of the six parameter groups (xyz, f_dc, f_rest,
// scaling, rotation, opacity) with their first and second moments, and the
// screen-gradient statistics of the step's view (grad_accum,
// grad_abs_accum, grad_abs_max, denom, max_radii2d). The plain version is
// train/optim.py:adam_step, then models/gaussian_model.py
// add_densification_stats (the screen gradient times (W/2, H/2)) and
// update_max_radii.
//
// Replaces no TPU kernel: radegs_tpu/train/optim.py:adam_step and the
// statistics are elementwise code that XLA fuses on the TPU. Under PyTorch
// the same chain is ~16 elementwise kernels a group and ~15 for the
// statistics, each a full pass over its tensors in device memory.
//
// What bounds it on an H100: bytes. A row of capacity holds 59 parameter
// floats at SH degree 3; Adam reads p, g, m and v and writes p, m and v
// (7 x 59 x 4 = 1652 B), the statistics read the screen gradient (8 B), the
// abs-gradient's column 0 (8 B of its sector), the visible and active flags
// and the radius (6 B) and read and write five accumulators (40 B): 1714 B
// a row, 4.29 ms at 2^23 rows at 3.35 TB/s. The ~20 FP32 operations an
// element (one IEEE division and one square root among them) are far below.
// What the design does about it:
//   - the six groups are one virtual index range of float4 chunks: each
//     group is a flat run of C x width floats, cut into blocks of NT x
//     ITEMS chunks, so a block belongs to one group and its threads read
//     neighbouring 16-byte words; a thread issues the loads of its ITEMS
//     chunks of p, g, m and v before any arithmetic, streamed past L1 and
//     marked evict-first (each word is read once), and writes its outputs
//     the same way;
//   - the row of an element is its index over the group's width, and the
//     row's active byte (read through L1: 4 to 45 elements share one) is
//     its mask; a group whose pointers are not all 16-byte aligned, and the
//     last chunk of a group whose length is not a multiple of 4, take a
//     scalar path;
//   - the statistics are a second range of blocks in the same launch, one
//     thread a row;
//   - every scalar comes from the host (learning rates, the bias
//     corrections' reciprocals, the NDC scale), so nothing is read back.
// Arithmetic: the plain chain's float32, rounded as PyTorch's CUDA kernels
// round it, so the two agree bit for bit: every product, sum, quotient and
// square root rounded on its own (__fmul_rn and friends, which the compiler
// never contracts into an FMA) in PyTorch's order, `tensor / float` as a
// product with the float32 reciprocal that PyTorch takes on the host, the
// two-lane vector norm as the two rounded squares summed, and maximum as
// torch.maximum (NaN wins). Inactive rows keep p and decay m and v with a
// gradient of +0, as torch.where(mask, g, 0.0) gives.
//
// Inputs and outputs, C rows: per group p, g (null: zeros), m, v, and new
// p, m, v, each a contiguous (C, width) float32 run; active and visible
// (C,) bool; the screen gradient (C, 2) (null: zeros); the abs-gradient
// (C, 2), column 0 read (null: zeros); radii (C,) float32; the five
// accumulators (C,) float32 in and out.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define UNROLL _Pragma("unroll")

namespace {

constexpr int NT = 256;    // threads a block
constexpr int ITEMS = 1;   // float4 chunks a thread
constexpr int NG = 6;      // parameter groups
constexpr int N_PTR = NG * 7 + 15;

// the plain chain's Python floats as PyTorch hands them to a float32 kernel
constexpr float BETA1 = static_cast<float>(0.9);
constexpr float ONE_MINUS_BETA1 = static_cast<float>(1.0 - 0.9);
constexpr float BETA2 = static_cast<float>(0.999);
constexpr float ONE_MINUS_BETA2 = static_cast<float>(1.0 - 0.999);
constexpr float EPS = static_cast<float>(1e-15);

struct Group {
  const float* p;
  const float* g;  // null: zeros
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  int len;     // C x width floats
  int width;   // floats a row
  int block0;  // the group's first block
  int vec;     // every pointer 16-byte aligned
  float lr;
};

struct Stats {
  const float* xy_grad;  // (C, 2) pixel units, null: zeros
  const float* xy_abs;   // (C, 2), column 0 read; null: zeros
  const bool* visible;
  const float* radii;
  const float* in[5];  // grad_accum, grad_abs_accum, grad_abs_max, denom, max_radii2d
  float* out[5];
  float sx, sy;  // the NDC scale (W/2, H/2)
};

struct Params {
  Group g[NG];
  Stats s;
  const bool* active;
  int C;
  int stats_block0;  // blocks from here on are statistics blocks
  float inv_bc1, inv_bc2;
};

// torch.maximum: a NaN on either side wins, else fmaxf
__device__ __forceinline__ float maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// one element: BETA1 * m + (1 - BETA1) * g, BETA2 * v + (1 - BETA2) * g * g,
// p - lr * (m / bc1) / (sqrt(v / bc2) + EPS), on an active row
__device__ __forceinline__ void adam(float p, float g, float m, float v, bool act, float lr,
                                     float ib1, float ib2, float& p_out, float& m_out,
                                     float& v_out) {
  const float gi = act ? g : 0.0f;
  const float m1 = __fadd_rn(__fmul_rn(BETA1, m), __fmul_rn(ONE_MINUS_BETA1, gi));
  const float v1 = __fadd_rn(__fmul_rn(BETA2, v), __fmul_rn(__fmul_rn(ONE_MINUS_BETA2, gi), gi));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, ib2)), EPS);
  const float upd = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, __fmul_rn(m1, ib1)), den));
  p_out = act ? upd : p;
  m_out = m1;
  v_out = v1;
}

__device__ __forceinline__ float4 load4(const float* base, int e) {
  return __ldcs(reinterpret_cast<const float4*>(base + e));
}

__device__ __forceinline__ void store4(float* base, int e, float4 x) {
  __stcs(reinterpret_cast<float4*>(base + e), x);
}

// a bool of a (C,) flag tensor, read through the read-only cache
__device__ __forceinline__ bool flag(const bool* f, int r) {
  return __ldg(reinterpret_cast<const unsigned char*>(f) + r) != 0;
}

// the active flags of elements e .. e + 3 of a group of width w
__device__ __forceinline__ void row_flags(const bool* active, int e, int w, bool (&act)[4]) {
  int r = e / w, col = e - r * w;
  UNROLL
  for (int j = 0; j < 4; ++j) {
    act[j] = flag(active, r);
    if (++col == w) {
      col = 0;
      ++r;
    }
  }
}

__device__ void adam_block(const Params& P, const Group& G, int block) {
  const int c0 = block * NT * ITEMS + static_cast<int>(threadIdx.x);
  const float ib1 = P.inv_bc1, ib2 = P.inv_bc2, lr = G.lr;
  if (G.vec && 4 * (c0 + (ITEMS - 1) * NT) + 4 <= G.len) {
    float4 p[ITEMS], g[ITEMS], m[ITEMS], v[ITEMS];
    UNROLL
    for (int u = 0; u < ITEMS; ++u) {
      const int e = 4 * (c0 + u * NT);
      p[u] = load4(G.p, e);
      g[u] = G.g ? load4(G.g, e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      m[u] = load4(G.m, e);
      v[u] = load4(G.v, e);
    }
    UNROLL
    for (int u = 0; u < ITEMS; ++u) {
      const int e = 4 * (c0 + u * NT);
      bool act[4];
      row_flags(P.active, e, G.width, act);
      float4 po, mo, vo;
      adam(p[u].x, g[u].x, m[u].x, v[u].x, act[0], lr, ib1, ib2, po.x, mo.x, vo.x);
      adam(p[u].y, g[u].y, m[u].y, v[u].y, act[1], lr, ib1, ib2, po.y, mo.y, vo.y);
      adam(p[u].z, g[u].z, m[u].z, v[u].z, act[2], lr, ib1, ib2, po.z, mo.z, vo.z);
      adam(p[u].w, g[u].w, m[u].w, v[u].w, act[3], lr, ib1, ib2, po.w, mo.w, vo.w);
      store4(G.p_out, e, po);
      store4(G.m_out, e, mo);
      store4(G.v_out, e, vo);
    }
    return;
  }
  // the scalar path: a group's last chunks, or a group not 16-byte aligned
  for (int u = 0; u < ITEMS; ++u) {
    const int e0 = 4 * (c0 + u * NT);
    for (int e = e0; e < e0 + 4 && e < G.len; ++e) {
      const bool act = flag(P.active, e / G.width);
      adam(G.p[e], G.g ? G.g[e] : 0.0f, G.m[e], G.v[e], act, lr, ib1, ib2, G.p_out[e],
           G.m_out[e], G.v_out[e]);
    }
  }
}

__device__ void stats_row(const Params& P, int r) {
  if (r >= P.C) return;
  const Stats& S = P.s;
  const bool vis = S.visible[r] && P.active[r];
  const float gx = __fmul_rn(S.xy_grad ? S.xy_grad[2 * r] : 0.0f, S.sx);
  const float gy = __fmul_rn(S.xy_grad ? S.xy_grad[2 * r + 1] : 0.0f, S.sy);
  // torch.linalg.vector_norm over the last dimension of 2
  const float gnorm = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  const float abs_g = vis && S.xy_abs != nullptr ? S.xy_abs[2 * r] : 0.0f;
  S.out[0][r] = __fadd_rn(S.in[0][r], vis ? gnorm : 0.0f);
  S.out[1][r] = __fadd_rn(S.in[1][r], abs_g);
  S.out[2][r] = maximum(S.in[2][r], abs_g);
  S.out[3][r] = __fadd_rn(S.in[3][r], vis ? 1.0f : 0.0f);
  const float radius = S.in[4][r];
  S.out[4][r] = vis ? maximum(radius, S.radii[r]) : radius;
}

__global__ void __launch_bounds__(NT) adam_stats_kernel(const Params P) {
  const int b = static_cast<int>(blockIdx.x);
  if (b >= P.stats_block0) {
    stats_row(P, (b - P.stats_block0) * NT + static_cast<int>(threadIdx.x));
    return;
  }
  // the group of this block (an empty group has no blocks: its block0 is
  // the next group's, and the later group is taken)
  Group G = P.g[0];
  UNROLL
  for (int i = 1; i < NG; ++i) {
    if (b >= P.g[i].block0) G = P.g[i];
  }
  adam_block(P, G, b - G.block0);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// ptrs: a host array of N_PTR device pointers: for each group in the order
// xyz, f_dc, f_rest, scaling, rotation, opacity its p, g (may be null), m,
// v, p_out, m_out, v_out; then active, visible, xy_grad (may be null),
// xy_abs (may be null), radii, the five accumulators in (grad_accum,
// grad_abs_accum, grad_abs_max, denom, max_radii2d) and out.
// widths: the groups' floats a row (f_rest's may be 0); lrs: their learning
// rates; inv_bc1, inv_bc2: the float32 reciprocals of the bias corrections.
extern "C" int radegs_adam_stats(const void* ptrs, int C, int w0, int w1, int w2, int w3,
                                 int w4, int w5, float lr0, float lr1, float lr2, float lr3,
                                 float lr4, float lr5, float inv_bc1, float inv_bc2, float sx,
                                 float sy, void* stream) {
  const int widths[NG] = {w0, w1, w2, w3, w4, w5};
  const float lrs[NG] = {lr0, lr1, lr2, lr3, lr4, lr5};
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const void* const* ptr = static_cast<const void* const*>(ptrs);
  Params P{};
  long long blocks = 0;
  for (int k = 0; k < NG; ++k) {
    const void* const* q = ptr + 7 * k;
    const long long len = static_cast<long long>(C) * widths[k];
    // element indices stay in int: 4 x (chunk + one block) must not overflow
    if (widths[k] < 0 || len > INT_MAX - 8LL * NT * ITEMS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Group& G = P.g[k];
    G.p = static_cast<const float*>(q[0]);
    G.g = static_cast<const float*>(q[1]);
    G.m = static_cast<const float*>(q[2]);
    G.v = static_cast<const float*>(q[3]);
    G.p_out = static_cast<float*>(const_cast<void*>(q[4]));
    G.m_out = static_cast<float*>(const_cast<void*>(q[5]));
    G.v_out = static_cast<float*>(const_cast<void*>(q[6]));
    G.len = static_cast<int>(len);
    G.width = widths[k];
    G.block0 = static_cast<int>(blocks);
    G.vec = aligned16(G.p) && aligned16(G.g) && aligned16(G.m) && aligned16(G.v) &&
            aligned16(G.p_out) && aligned16(G.m_out) && aligned16(G.v_out);
    G.lr = lrs[k];
    blocks += (len + 4LL * NT * ITEMS - 1) / (4LL * NT * ITEMS);
  }
  const void* const* q = ptr + 7 * NG;
  P.active = static_cast<const bool*>(q[0]);
  P.s.visible = static_cast<const bool*>(q[1]);
  P.s.xy_grad = static_cast<const float*>(q[2]);
  P.s.xy_abs = static_cast<const float*>(q[3]);
  P.s.radii = static_cast<const float*>(q[4]);
  for (int i = 0; i < 5; ++i) {
    P.s.in[i] = static_cast<const float*>(q[5 + i]);
    P.s.out[i] = static_cast<float*>(const_cast<void*>(q[10 + i]));
  }
  P.s.sx = sx;
  P.s.sy = sy;
  P.C = C;
  P.stats_block0 = static_cast<int>(blocks);
  P.inv_bc1 = inv_bc1;
  P.inv_bc2 = inv_bc2;
  blocks += (C + NT - 1) / NT;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(N_PTR == 57, "the pointer list of the C entry");
  adam_stats_kernel<<<static_cast<unsigned>(blocks), NT, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
