// What the forward and the backward blend kernels (blend_fwd.cu,
// blend_bwd.cu) share: the tile shape, the feature-row layout, and the gate
// arithmetic that decides whether a contributor is skipped, blended, or ends
// its pixel. Both kernels take these decisions through the functions below,
// so the backward re-walk includes exactly the contributors the forward did.
// Also the cp.async helpers of the kernels that gather rows into a ring, and
// the per-tile barrier of the blend kernels that run G tiles a block.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace radegs {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // pixels (threads) per tile
constexpr int NF4 = 6;           // a feature row: 24 floats = 6 float4

// the Python doubles of radegs_torch/ops/blend.py, rounded to float as
// PyTorch rounds them when it compares a float32 tensor with them
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float T_EPS = (float)1e-4;
constexpr float MAX_ALPHA = (float)0.99;

// feature row: a row of the per-Gaussian table the preprocess writes, whose
// layout radegs_torch/core/projection.py (COLUMNS) owns (the FEAT_LAYOUT of
// radegs_tpu/ops/pallas_blend.py): 0:2 xy, 2:5 conic (a, b, c), 5 opacity
// (0 where the row is not valid), 6:9 rgb, 9 ts, 10:12 ray_plane,
// 12:15 view_point, 15:18 camera_plane x, 18:21 camera_plane y, 21:24 normal

// -0.5 (a dx^2 + c dy^2) - b dx dy, rounded op by op (no FMA contraction) in
// the order of blend_forward_torch, so the kernels and the plain version
// take the same skip / stop decisions.
__device__ __forceinline__ float gate_power(const float* f, float dx, float dy) {
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(f[2], dx), dx),
                                 __fmul_rn(__fmul_rn(f[4], dy), dy))),
      __fmul_rn(__fmul_rn(f[3], dx), dy));
}

// A contributor's alpha from its opacity and its falloff exp(power), clipped
// at 0.99 (forward.cu:565); the caller skips it below ALPHA_EPS.
__device__ __forceinline__ float gate_alpha(float opacity, float falloff) {
  return fminf(MAX_ALPHA, opacity * falloff);
}

// The transmittance after a contributor of opacity `alpha`; the pixel stops
// (and the contributor is excluded) when it falls below T_EPS.
__device__ __forceinline__ float gate_next_t(float T, float alpha) {
  return __fmul_rn(T, 1.0f - alpha);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte asynchronous copy from device to shared memory (cp.async,
// bypassing L1), in this thread's current copy group.
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Close this thread's current copy group (an empty group is allowed).
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Barrier ID (1 + the tile's index in its block; 0 is __syncthreads') of
// one tile's N threads; returns whether `pred` holds on every one of them.
// The ID is an immediate, so ptxas reserves only the barriers in use.
template <int ID, int N>
__device__ __forceinline__ bool bar_and(bool pred) {
  uint32_t all;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.and.pred q, %2, %3, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(all)
      : "r"(static_cast<uint32_t>(pred)), "n"(ID), "n"(N)
      : "memory");
  return all != 0;
}

// The barrier of tile j (0 or 1) of a block of G tiles of N threads each.
template <int G, int N>
__device__ __forceinline__ bool tile_sync_and(int j, bool pred) {
  static_assert(G == 1 || G == 2, "one or two tiles per block");
  return G == 1 || j == 0 ? bar_and<1, N>(pred) : bar_and<2, N>(pred);
}

}  // namespace radegs
