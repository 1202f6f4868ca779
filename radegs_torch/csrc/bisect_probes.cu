// The four bisect probes on Hopper (sm_90a): the smallest kernels that use
// what later redesigns of the blend and integrate kernels need — an
// asynchronous bulk copy of a feature window into shared memory completed
// on a barrier, a loop of such copies over one tile's run, and a full-FP32
// product inside a kernel.
//
// Replaces the TPU kernels of scripts/_kernel_bisect.py (D): k_aligned
// (:43), k_window (:53), k_mm_highest (:72) and k_tri_mm (:86), all run
// through one pallas_call (:32) over a grid of T steps with the feature
// matrix feat (25, B) float32 in device memory, per-step start / count
// (int32, scalar-prefetched there) and an (T, 8, 256) float32 output.
//
// What each computes for grid step t (one block per step here, 256
// threads, thread j owns output column j of the 8 rows):
//   aligned     the sum of feat[0:25, 0:128], broadcast;
//   window      the sum over n = cdiv(start - start_al + count, 128) whole
//               128-column windows from start_al = start // 128 * 128 (n = 0
//               when count == 0), broadcast;
//   mm_highest  rows 0..7 of f[0:19] @ w with w[c, j] = f[0, c], f =
//               feat[:, 0:128], in FP32 FFMA (Precision.HIGHEST is full FP32:
//               no TF32, no tensor cores);
//   tri_mm      rows 0..7 of tri @ x, tri[r, c] = (r >= c), x[c, j] = f[0, c]:
//               the inclusive prefix sum of f[0, 0..7], broadcast over 256.
//
// Staging: a 25 x 128 window is 25 row copies of 512 bytes with
// cp.async.bulk (the Tensor Memory Accelerator's bulk path) into shared
// memory, completed on an mbarrier that one thread arms with the expected
// byte count — the TPU's make_async_copy + DMA semaphore. `window` keeps two
// windows in flight (two buffers, two barriers). A bulk copy needs 16-byte
// aligned addresses: the wrapper requires B % 128 == 0; `window` checks each
// step's windows against the matrix itself and writes NaN for a step whose
// windows leave it.
//
// What bounds it on an H100: bytes for aligned / window (each staged value
// is read once and added once), a few microseconds of launch for the
// rest at these sizes. The sums are reduced in a fixed order (per thread,
// then warp shuffles, then the 8 warps in order): bit-identical from run to
// run.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;        // columns of one window
constexpr int ROWS = 25;       // feature rows
constexpr int THREADS = 256;   // one block per grid step
constexpr int OUT_ROWS = 8;
constexpr int WIN = ROWS * CH; // floats of one window
constexpr uint32_t WIN_BYTES = WIN * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: arm `bar` for a whole window and issue its 25 row copies
// (columns col0 .. col0 + 127 of each row) into `dst`.
__device__ __forceinline__ void stage_window(float* dst, const float* feat, long long B,
                                             long long col0, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  // the buffer may have been read through the generic proxy before: order
  // those reads before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(WIN_BYTES)
               : "memory");
  for (int r = 0; r < ROWS; ++r) {
    const float* src = feat + r * B + col0;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(dst + r * CH)),
        "l"(src), "r"(static_cast<uint32_t>(CH * 4)), "r"(b)
        : "memory");
  }
}

// The block's sum of one value per thread, in a fixed order; every thread
// gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void broadcast(float* out, int t, float v) {
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i) out[(t * OUT_ROWS + i) * THREADS + threadIdx.x] = v;
}

// This thread's share of a staged window: elements j, j + 256, ...
__device__ __forceinline__ float window_part(const float* w) {
  float s = 0.0f;
  for (int k = threadIdx.x; k < WIN; k += THREADS) s += w[k];
  return s;
}

__global__ void __launch_bounds__(THREADS)
aligned_kernel(const float* __restrict__ feat, long long B, float* __restrict__ out) {
  __shared__ __align__(128) float buf[WIN];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[THREADS / 32];
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) stage_window(buf, feat, B, 0, &bar);
  mbar_wait(&bar, 0);
  broadcast(out, blockIdx.x, block_sum(window_part(buf), red));
}

__global__ void __launch_bounds__(THREADS)
window_kernel(const int* __restrict__ start, const int* __restrict__ count,
              const float* __restrict__ feat, long long B, float* __restrict__ out) {
  __shared__ __align__(128) float buf[2][WIN];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[THREADS / 32];
  const int t = blockIdx.x;
  const long long s = start[t];
  const long long c = count[t];
  const long long start_al = s / CH * CH;
  const int n = c > 0 ? static_cast<int>((s - start_al + c + CH - 1) / CH) : 0;
  if (s < 0 || start_al + static_cast<long long>(n) * CH > B) {
    // windows outside the matrix: no copy, the step is NaN (the plain
    // version's answer); the host never reads the bounds back
    broadcast(out, t, __int_as_float(0x7fc00000));
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 && k < n; ++k) stage_window(buf[k], feat, B, start_al + k * CH, &bar[k]);
  }
  float acc = 0.0f;
  for (int ci = 0; ci < n; ++ci) {
    const int b = ci & 1;
    mbar_wait(&bar[b], (ci >> 1) & 1);
    acc += window_part(buf[b]);
    __syncthreads();  // every thread is done with buf[b]
    if (threadIdx.x == 0 && ci + 2 < n)
      stage_window(buf[b], feat, B, start_al + (ci + 2) * CH, &bar[b]);
  }
  broadcast(out, t, block_sum(acc, red));
}

// mm_highest (tri == false) and tri_mm (tri == true): thread j computes
// column j of rows 0..7 as a 128-term FP32 FMA chain over the staged rows.
template <bool TRI>
__global__ void __launch_bounds__(THREADS)
product_kernel(const float* __restrict__ feat, long long B, float* __restrict__ out) {
  __shared__ __align__(128) float buf[WIN];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) stage_window(buf, feat, B, 0, &bar);
  mbar_wait(&bar, 0);
  float acc[OUT_ROWS];
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i) acc[i] = 0.0f;
  for (int c = 0; c < CH; ++c) {
    const float w = buf[c];  // w[c, j] = x[c, j] = f[0, c]
#pragma unroll
    for (int i = 0; i < OUT_ROWS; ++i) {
      const float a = TRI ? (i >= c ? 1.0f : 0.0f) : buf[i * CH + c];
      acc[i] = __fmaf_rn(a, w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i)
    out[(blockIdx.x * OUT_ROWS + i) * THREADS + threadIdx.x] = acc[i];
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/bisect.py: probe 0 aligned,
// 1 window, 2 mm_highest, 3 tri_mm; one block per grid step on `stream`.
// feat is (25, B) float32 row-major with B % 128 == 0. Returns
// cudaGetLastError() (0 on success).
extern "C" int radegs_bisect_probes(const void* start, const void* count, const void* feat,
                                    void* out, int probe, int T, int B, void* stream) {
  if (T <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feat);
  auto* o = static_cast<float*>(out);
  switch (probe) {
    case 0: aligned_kernel<<<T, THREADS, 0, s>>>(f, B, o); break;
    case 1:
      window_kernel<<<T, THREADS, 0, s>>>(static_cast<const int*>(start),
                                          static_cast<const int*>(count), f, B, o);
      break;
    case 2: product_kernel<false><<<T, THREADS, 0, s>>>(f, B, o); break;
    case 3: product_kernel<true><<<T, THREADS, 0, s>>>(f, B, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
