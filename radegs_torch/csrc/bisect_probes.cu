// The four bisect probes on Hopper (sm_90a): the smallest kernels that use
// what the blend and integrate kernels need — a ring of tensor-map copies
// streamed over one tile's run, plain 16-byte loads, full-FP32 dot
// products and a prefix sum as a warp scan.
//
// Replaces the TPU kernels of scripts/_kernel_bisect.py (D): k_aligned
// (:43), k_window (:53), k_mm_highest (:72) and k_tri_mm (:86), all run
// through one pallas_call (:32) over a grid of T steps with the feature
// matrix feat (25, B) float32 in device memory, per-step start / count
// (int32, scalar-prefetched there) and an (T, 8, 256) float32 output.
//
// What each computes for grid step t (one block per step here):
//   aligned     the sum of feat[0:25, 0:128], broadcast;
//   window      the sum over n = cdiv(start - start_al + count, 128) whole
//               128-column windows from start_al = start // 128 * 128 (n = 0
//               when count == 0), broadcast;
//   mm_highest  rows 0..7 of f[0:19] @ w with w[c, j] = f[0, c], f =
//               feat[:, 0:128], in FP32 FFMA (Precision.HIGHEST is full FP32:
//               no TF32, no tensor cores);
//   tri_mm      rows 0..7 of tri @ x, tri[r, c] = (r >= c), x[c, j] = f[0, c]:
//               the inclusive prefix sum of f[0, 0..7], broadcast over 256.
// Rows are read in 16-byte units: the wrapper requires B % 128 == 0.
//
// aligned, mm_highest, tri_mm: the launch, one load round trip and the 32
// KB of stores of a (4, 8, 256) output bound them, not bytes or FLOPs. Each
// reads with plain loads, all in flight before the first add, and stores
// its (8, 256) slab as float4s. A bulk copy does not pay at this size: its
// barrier, serial issue and round trip cost more than the read. mm_highest
// is R[i, j] = f[i, 0:128] . f[0, 0:128] (w's columns are all f[0]): 8 dot
// products once a block with __fmaf_rn (1,024 multiply-adds fill no
// tensor-core tile); rows 8..18 of f never reach R[:8] and are not read.
// tri_mm, the TPU's product with a lower-triangular matrix, is a shuffle
// scan of 8 values. aligned's eight warps split the rows and mm_highest
// gives each warp a row, both meeting at one barrier: on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py --probes, CUDA graphs of 100 launches
// at the JAX shapes) that was faster than one warp a block reading all 25
// rows (2.25 against 1.46 us) and than every warp computing all 8 rows by
// a reduce-scatter, with no barrier (1.556 against 1.422 us).
//
// window: bytes bound it. It streams a step's windows through a ring of
// STAGES windows in dynamic shared memory, each a 2D tensor-map copy
// (cp.async.bulk.tensor.2d, a 25 x 128 box) completed on an mbarrier armed
// with its byte count — the TPU's make_async_copy + DMA semaphore. One
// producer thread (warp 8, lane 0) issues min(n, STAGES) windows at block
// start and refills a stage once the eight consumer warps have arrived on
// its `empty` barrier: no block-wide barrier per window. A step whose
// windows leave the matrix writes NaN (checked on the card: the host never
// reads the bounds back). On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 9) S = 8 was the fastest ring of 2..16 windows at
// the dense view 0's run layout (0.2781 ms, 86% of its bytes bound); at
// 102.4 KB two blocks share an SM.
//
// The sums are reduced in a fixed order (per thread, then warp shuffles,
// then the warps in order; the scan in a fixed tree): bit-identical from
// run to run.

#include <cstdint>

#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;        // columns of one window
constexpr int ROWS = 25;       // feature rows
constexpr int THREADS = 256;   // one block per grid step (window: consumers)
constexpr int OUT_ROWS = 8;
constexpr int WIN = ROWS * CH; // floats of one window
constexpr uint32_t WIN_BYTES = WIN * 4;
constexpr int STAGES = 8;      // windows in the `window` ring
constexpr int CONSUMER_WARPS = THREADS / 32;
constexpr int WINDOW_THREADS = THREADS + 32;  // the consumers and one producer warp
constexpr int RING_BYTES = STAGES * WIN_BYTES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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

// A whole window, columns col0 .. col0 + 127 of the 25 rows, into dst as
// one 2D box of `map` (25 x 128 floats, row-major), completing on `bar`.
__device__ __forceinline__ void copy_window(float* dst, const CUtensorMap* map, int col0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(0), "r"(smem_addr(bar))
      : "memory");
}

// The sum of one value per thread over threads 0..THREADS-1, in a fixed
// order; every one of them gets it. They meet on hardware barrier BAR: 0 is
// __syncthreads (a block of THREADS threads), another id only those threads.
template <int BAR>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  if constexpr (BAR == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"n"(BAR), "n"(THREADS) : "memory");
  }
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void broadcast(float* out, int t, float v) {
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i) out[(t * OUT_ROWS + i) * THREADS + threadIdx.x] = v;
}

// The block's (8, 256) slab of step t as float4s, 2 a thread: float4 q
// holds row q / 64, whose value is row_value(q / 64).
template <class RowValue>
__device__ __forceinline__ void store_slab(float* out, int t, RowValue row_value) {
  float4* slab = reinterpret_cast<float4*>(out + t * OUT_ROWS * THREADS);
  constexpr int PER_ROW = THREADS / 4;
#pragma unroll
  for (int k = 0; k < OUT_ROWS * PER_ROW / THREADS; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const float p = row_value(q / PER_ROW);
    slab[q] = make_float4(p, p, p, p);
  }
}

// This thread's share of a staged window: float4s j, j + 256, ... (4
// partial sums)
__device__ __forceinline__ float window_part4(const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = threadIdx.x; k < WIN / 4; k += THREADS) {
    const float4 v = w4[k];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return (s.x + s.y) + (s.z + s.w);
}

// aligned: warp w reads rows w, w + 8, ... (< 25; zeros past the last) of
// the window, one float4 a lane per row, every load issued before the first
// add.
__global__ void __launch_bounds__(THREADS)
aligned_kernel(const float* __restrict__ feat, long long B, float* __restrict__ out) {
  constexpr int WARPS = THREADS / 32;
  constexpr int PER_WARP = (ROWS + WARPS - 1) / WARPS;
  const int warp = threadIdx.x >> 5;
  __builtin_assume(warp < WARPS);  // so rows w, w + 8, w + 16 need no test
  const float4* f4 = reinterpret_cast<const float4*>(feat) + (threadIdx.x & 31);
  float4 v[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int r = warp + k * WARPS;
    v[k] = r < ROWS ? __ldg(f4 + r * (B / 4)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  __shared__ float red[WARPS];
  s = block_sum<0>(s, red);
  store_slab(out, blockIdx.x, [s](int) { return s; });
}

// Threads 0..255 consume (thread j owns output column j), thread 256 produces.
__global__ void __launch_bounds__(WINDOW_THREADS)
window_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ start,
              const int* __restrict__ count, long long B, float* __restrict__ out) {
  extern __shared__ __align__(128) float ring[];  // STAGES windows
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ float red[CONSUMER_WARPS];
  const int t = blockIdx.x;
  const long long s = start[t];
  const long long c = count[t];
  const long long start_al = s / CH * CH;
  const int n = c > 0 ? static_cast<int>((s - start_al + c + CH - 1) / CH) : 0;
  if (s < 0 || start_al + static_cast<long long>(n) * CH > B) {
    // windows outside the matrix: no copy, the step is NaN (the plain
    // version's answer)
    if (threadIdx.x < THREADS) broadcast(out, t, __int_as_float(0x7fc00000));
    return;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= THREADS) {
    // the producer: window k goes to stage k % STAGES; from the second round
    // on, a stage is refilled once the consumers have released its last window
    if (lane != 0) return;
    int st = 0;
    uint32_t round = 0;  // parity of k / STAGES
    for (int k = 0; k < n; ++k) {
      if (k >= STAGES) mbar_wait(&empty[st], round ^ 1);
      // the stage was read through the generic proxy: order those reads
      // before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(&full[st], WIN_BYTES);
      copy_window(ring + st * WIN, &map, static_cast<int>(start_al) + k * CH, &full[st]);
      if (++st == STAGES) {
        st = 0;
        round ^= 1;
      }
    }
    return;  // the consumers wait for every copy this thread issued
  }
  float acc = 0.0f;
  int st = 0;
  uint32_t round = 0;
  for (int k = 0; k < n; ++k) {
    mbar_wait(&full[st], round);
    acc += window_part4(ring + st * WIN);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == STAGES) {
      st = 0;
      round ^= 1;
    }
  }
  // barrier 1: the consumers only (the producer warp has left)
  broadcast(out, t, block_sum<1>(acc, red));
}

// mm_highest: warp w computes row w, each lane on float4 `lane` of row w
// and of row 0; the 8 sums meet in shared memory at one barrier.
__global__ void __launch_bounds__(THREADS)
product_kernel(const float* __restrict__ feat, long long B, float* __restrict__ out) {
  static_assert(THREADS == 32 * OUT_ROWS, "a warp per row of R");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* f4 = reinterpret_cast<const float4*>(feat) + lane;
  // both loads issued at once (warp 0 reads row 0 twice: a select of x
  // would wait for x before issuing the second)
  const float4 x = __ldg(f4);  // f[0, 4 lane .. 4 lane + 3]
  const float4 v = __ldg(f4 + warp * (B / 4));
  float acc = __fmaf_rn(v.w, x.w, __fmaf_rn(v.z, x.z, __fmaf_rn(v.y, x.y, __fmul_rn(v.x, x.x))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ float dots[OUT_ROWS];
  if (lane == 0) dots[warp] = acc;
  __syncthreads();
  store_slab(out, blockIdx.x, [&](int r) { return dots[r]; });
}

// tri_mm: every warp scans f[0, 0..7] itself (lanes 8..31 repeat lanes
// 0..7), then the block stores its slab as 512 float4s; float4 q holds row
// q / 64, which lane q / 64 of the scan carries.
__global__ void __launch_bounds__(THREADS)
tri_mm_kernel(const float* __restrict__ feat, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (OUT_ROWS - 1);
  float v = feat[r];
#pragma unroll
  for (int o = 1; o < OUT_ROWS; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o, OUT_ROWS);
    if (r >= o) v += u;
  }
  float4* slab = reinterpret_cast<float4*>(out + blockIdx.x * OUT_ROWS * THREADS);
  constexpr int PER_ROW = THREADS / 4;
#pragma unroll
  for (int q = threadIdx.x; q < OUT_ROWS * PER_ROW; q += THREADS) {
    const float p = __shfl_sync(0xffffffffu, v, q / PER_ROW);
    slab[q] = make_float4(p, p, p, p);
  }
}

// The tensor map of feat (25, B) float32 for window copies: 25 x 128 boxes,
// no swizzle. cuTensorMapEncodeTiled is a driver function, reached through
// the runtime so that the library links against libcudart alone.
cudaError_t window_map(CUtensorMap* map, const float* feat, int B) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), ROWS};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(B) * 4};  // bytes between rows
  const cuuint32_t box[2] = {CH, ROWS};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(feat), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The window kernel's ring exceeds the default 48 KB of shared memory: allow
// it once per device.
cudaError_t allow_ring(void) {
  static uint64_t allowed = 0;  // bit d: device d done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (allowed >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RING_BYTES);
  if (err == cudaSuccess && dev < 64) allowed |= uint64_t{1} << dev;
  return err;
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
    case 1: {
      CUtensorMap map;
      cudaError_t err = allow_ring();
      if (err == cudaSuccess) err = window_map(&map, f, B);
      if (err != cudaSuccess) return static_cast<int>(err);
      window_kernel<<<T, WINDOW_THREADS, RING_BYTES, s>>>(
          map, static_cast<const int*>(start), static_cast<const int*>(count), B, o);
      break;
    }
    case 2: product_kernel<<<T, THREADS, 0, s>>>(f, B, o); break;
    case 3: tri_mm_kernel<<<T, THREADS, 0, s>>>(f, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
