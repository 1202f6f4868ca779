// Preprocess forward of RaDe-GS on Hopper (sm_90a), for views that need no
// gradient: in one pass over the state's rows, the whole of
// renderer.prepare — the activations of the state's raw tensors (exp of the
// log-scales, sigmoid of the opacity logit, the quaternion normalised), the
// Mip 3D filter fused into scale and opacity (fuse_3d_filter), the active
// mask, the view transform and near cull, the NDC projection, the EWA 2D
// covariance with its cone clamp and the 2D filter (kernel_size, with its
// opacity compensation), conic and radius, RaDe-GS's ray-space planes,
// camera plane and normal (the smallest-axis branch where the covariance is
// ill-conditioned), the centre's ray distance, SH colour at the state's
// active degree and, for integration, the inverse ray-space covariance
// (reference preprocessCUDA forward.cu:307-423, computeCov2D forward.cu:77-264;
// the plain version is core/projection.py:preprocess_gaussians behind the
// state's getters).
//
// Replaces no TPU kernel: the JAX package's preprocess is XLA (per-splat
// elementwise code that XLA fuses). Under PyTorch the same chain is ~1200
// small kernels a view (stacks, concatenations, (P,3,3,3) broadcast products
// and their reductions), most of a served view's time.
//
// What bounds it on an H100: bytes. An active row reads its 59 parameter
// floats, its 3D filter and its active flag (~241 B at SH degree 3) and
// every row writes the 24-float feature row, a radius and two flags
// (102 B); the ~600 FP32 operations of a row are far below. What the design
// does about it:
//   - one thread a row, NT rows a block; the block's rows of f_rest (45
//     floats a row at degree 3: 180 B, not 16-byte aligned) are one
//     contiguous run, staged into shared memory as 16-byte loads, coalesced,
//     and read back by each thread at a stride of 45 words (odd: no bank
//     conflict); rotation is one float4 a row;
//   - an inactive row reads only its active flag: the staging skips the
//     16-byte parts that touch no active row, and a block with no active row
//     stages nothing;
//   - the feature row is written as six float4 in the table's column order
//     (preprocess_common.cuh; its owner is core/projection.py COLUMNS), so
//     the table is the blend's feature table; the camera's derived terms
//     (tangents, focals, the view and projection rows, its centre) are
//     computed once a block from R, T, fovx and fovy in device memory, so
//     nothing is read back to the host.
// Arithmetic: the plain version's float32, rounded as PyTorch's CUDA kernels
// round it, so the two agree bit for bit (a last-bit difference in a conic
// or an opacity moves a pixel's 1/255 alpha gate): its formulas, clamps and
// order of operations, a reciprocal where PyTorch takes one for
// `scalar / tensor`, IEEE division and square root, no fast-math
// intrinsics; every operation rounded on its own, as PyTorch's separate
// kernels round them, but for the FMAs of cuBLAS's (P,3) x (3,3) products,
// written out with __fmaf_rn: each product that meets an addition is
// __fmul_rn, which the compiler never contracts into an FMA; each small
// reduction in the order PyTorch's reduce kernel takes (sum3, quad, norm3,
// norm4, mul, mul_bt, the SH sum; measured on the card against PyTorch
// 2.11). preprocess_common.cuh holds those helpers, shared with the backward.
//
// Output, for rows [0, P): feat (P, N_FEAT) float32, the columns xy 0:2, conic
// 2:5, opacity 5 (0 on a row that is not valid), rgb 6:9, ts 9, ray_plane
// 10:12, view_point 12:15, camera_plane[:, :, 0] 15:18, camera_plane[:, :, 1]
// 18:21, normal 21:24; radius (P,) float32 (0 where not valid); valid and
// well_conditioned (P,) bool; invraycov (P, 3, 3) float32 when asked. An
// inactive row writes valid false, radius 0 and zeros elsewhere.

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

using namespace radegs;

namespace {

constexpr int NT = 128;  // rows (threads) a block

struct Outputs {
  float4* feat;  // (P, N_FEAT) as six float4 a row
  float* radius;
  bool* valid;
  bool* well;
  float* invraycov;  // (P, 3, 3), or null
};

// the row of an inactive splat
template <bool INV>
__device__ __forceinline__ void write_culled(const Outputs& o, int i) {
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < N_FEAT / 4; ++k) o.feat[(size_t)i * (N_FEAT / 4) + k] = z4;
  o.radius[i] = 0.f;
  o.valid[i] = false;
  o.well[i] = false;
  if constexpr (INV) {
#pragma unroll
    for (int k = 0; k < 9; ++k) o.invraycov[(size_t)i * 9 + k] = 0.f;
  }
}

template <int D, bool INV>
__global__ void __launch_bounds__(NT)
preprocess_fwd_kernel(Inputs in, Outputs out, int P, int width, int height, int n_sh,
                      float kernel_size, float scale_modifier) {
  constexpr int M = (D + 1) * (D + 1);
  constexpr int REST = (M - 1) * 3;  // f_rest floats a row
  __shared__ Cam cam;
  __shared__ bool act[NT];
  __shared__ __align__(16) float rest[REST > 0 ? NT * REST : 4];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * NT;
  const int i = row0 + t;
  const bool live = i < P && in.active[i];
  act[t] = live;
  if (t == 0) cam = make_cam(in, width, height);
  if (!__syncthreads_or(live)) {  // no active row in the block
    if (i < P) write_culled<INV>(out, i);
    return;
  }

  // the row's own parameters, in flight while the block stages f_rest
  float p[3], ls[3], dc[3];
  float4 q4 = make_float4(1.f, 0.f, 0.f, 0.f);
  float op_logit = 0.f, filt = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = in.xyz[(size_t)i * 3 + k];
      ls[k] = in.scaling[(size_t)i * 3 + k];
      dc[k] = in.f_dc[(size_t)i * 3 + k];
    }
    q4 = in.rotation[i];
    op_logit = in.opacity[i];
    filt = in.filter_3d[i];
  }
  if constexpr (REST > 0) {
    const int n = min(NT, P - row0) * REST;  // floats of the block's rows
    const float* src = in.f_rest + (size_t)row0 * REST;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(rest);
    const int n4 = n / 4;
#pragma unroll 4
    for (int k = t; k < n4; k += NT) {
      if (act[(4 * k) / REST] || act[(4 * k + 3) / REST]) dst4[k] = __ldg(src4 + k);
    }
    for (int k = 4 * n4 + t; k < n; k += NT) {
      if (act[k / REST]) rest[k] = __ldg(src + k);
    }
    __syncthreads();
  }
  if (!live) {
    if (i < P) write_culled<INV>(out, i);
    return;
  }

  // ---- activations and the fused 3D filter (gaussian_model.py:157-166) ----
  float s2f[3], scale[3], r[3];
  const float f2 = __fmul_rn(filt, filt);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = expf(ls[k]);
    const float s2 = __fmul_rn(s, s);
    s2f[k] = s2 + f2;
    r[k] = s2 / s2f[k];
    scale[k] = sqrtf(s2f[k]);
  }
  // torch.prod over the last dimension of 3: lanes 0 and 2, then 1
  const float opac = (1.0f / (1.0f + expf(-op_logit))) * sqrtf((r[0] * r[2]) * r[1]);
  const float qn = norm4(q4.x, q4.y, q4.z, q4.w);
  const float qr = q4.x / qn, qx = q4.y / qn, qy = q4.z / qn, qz = q4.w / qn;

  // ---- world covariance, its inverse, the smallest axis (forward.cu:142-155) ----
  const float Rq[3][3] = {
      {1.f - __fmul_rn(2.f, __fmul_rn(qy, qy) + __fmul_rn(qz, qz)),
       2.f * (__fmul_rn(qx, qy) - __fmul_rn(qr, qz)),
       2.f * (__fmul_rn(qx, qz) + __fmul_rn(qr, qy))},
      {2.f * (__fmul_rn(qx, qy) + __fmul_rn(qr, qz)),
       1.f - __fmul_rn(2.f, __fmul_rn(qx, qx) + __fmul_rn(qz, qz)),
       2.f * (__fmul_rn(qy, qz) - __fmul_rn(qr, qx))},
      {2.f * (__fmul_rn(qx, qz) - __fmul_rn(qr, qy)), 2.f * (__fmul_rn(qy, qz) + __fmul_rn(qr, qx)),
       1.f - __fmul_rn(2.f, __fmul_rn(qx, qx) + __fmul_rn(qy, qy))}};
  float s2m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sm = scale[k] * scale_modifier;
    s2m[k] = sm * sm;
  }
  float RS[3][3], RSi[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      RS[a][k] = Rq[a][k] * s2m[k];
      RSi[a][k] = Rq[a][k] * (1.0f / fmaxf(s2m[k], 1e-30f));
    }
  }
  float cov[3][3], vrk[3][3];
  mul_bt(RS, Rq, cov);
  int arg = 0;  // the first minimum
  if (s2m[1] < s2m[arg]) arg = 1;
  if (s2m[2] < s2m[arg]) arg = 2;
  const bool well = s2m[arg] > EIG_EPS;
  if (well) {
    mul_bt(RSi, Rq, vrk);
  } else {  // project onto the smallest axis
    float mv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) mv[a] = arg == 0 ? Rq[a][0] : (arg == 1 ? Rq[a][1] : Rq[a][2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < 3; ++k) vrk[a][k] = mv[a] * mv[k];
    }
  }

  // ---- view transform, near cull, NDC projection (auxiliary.h:155-180) ----
  float pv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) pv[a] = affine(cam.w2c[a], p, cam.t[a]);
  const bool in_front = pv[2] > NEAR_PLANE;
  const float z = in_front ? pv[2] : 1.0f;
  const float hx = affine(cam.proj[0], p, cam.proj[0][3]);
  const float hy = affine(cam.proj[1], p, cam.proj[1][3]);
  const float pw = 1.0f / (pv[2] + 1e-7f);  // full_proj's w row is world_view's z row
  const float xy0 = (__fmul_rn(__fmul_rn(hx, pw) + 1.0f, cam.width) - 1.0f) * 0.5f;
  const float xy1 = (__fmul_rn(__fmul_rn(hy, pw) + 1.0f, cam.height) - 1.0f) * 0.5f;

  // ---- EWA cov2D with the cone clamp and the 2D filter (forward.cu:85-124) ----
  const float u = fminf(fmaxf(pv[0] / z, -cam.limx), cam.limx);
  const float v = fminf(fmaxf(pv[1] / z, -cam.limy), cam.limy);
  const float tx = __fmul_rn(u, z), ty = __fmul_rn(v, z);
  const float inv_z = 1.0f / z;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = cam.fx * inv_z, j02 = -cam.fx * tx * inv_z2;
  const float j11 = cam.fy * inv_z, j12 = -cam.fy * ty * inv_z2;
  float m0[3], m1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m0[k] = __fmul_rn(j00, cam.w2c[0][k]) + __fmul_rn(j02, cam.w2c[2][k]);
    m1[k] = __fmul_rn(j11, cam.w2c[1][k]) + __fmul_rn(j12, cam.w2c[2][k]);
  }
  const float a0 = quad(m0, cov, m0), b0 = quad(m0, cov, m1), c0 = quad(m1, cov, m1);
  const float det0 = fmaxf(__fmul_rn(a0, c0) - __fmul_rn(b0, b0), 1e-6f);
  const float a1 = a0 + kernel_size, c1 = c0 + kernel_size;
  const float det = __fmul_rn(a1, c1) - __fmul_rn(b0, b0);
  const float det1m = fmaxf(det, 1e-6f);
  const float coef = (det0 <= 1e-6f || det1m <= 1e-6f) ? 0.f : sqrtf(det0 / (det1m + 1e-6f) + 1e-6f);
  const bool nonsingular = det != 0.0f;
  const float det_inv = 1.0f / (nonsingular ? det : 1.0f);

  // ---- screen-space radius (forward.cu:391-398) ----
  const float radius = screen_radius(a1, c1, det);
  const bool valid = in_front && nonsingular && radius > 0.0f;

  // ---- ray-space planes and normal (forward.cu:135-262) ----
  float A[3][3], cam_inv[3][3];
  mul(cam.w2c, vrk, A);
  mul_bt(A, cam.w2c, cam_inv);
  float mv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mv[a] = sum3(__fmul_rn(cam_inv[a][0], u), __fmul_rn(cam_inv[a][1], v), cam_inv[a][2]);
  }
  const float mn2 = sum3(__fmul_rn(mv[0], mv[0]), __fmul_rn(mv[1], mv[1]), __fmul_rn(mv[2], mv[2]));
  const float mn_norm = sqrtf(mn2);
  const float rmn = 1.0f / sqrtf(fmaxf(mn2, 1e-30f));
  const bool plane_ok = mn_norm > 1e-20f && isfinite(mn_norm);
  const float n0 = __fmul_rn(mv[0], rmn), n1 = __fmul_rn(mv[1], rmn), n2 = __fmul_rn(mv[2], rmn);
  const float rvbn = 1.0f / fmaxf(sum3(__fmul_rn(n0, u), __fmul_rn(n1, v), n2), 1e-7f);
  const float w0 = n0 * rvbn, w1 = n1 * rvbn, w2 = n2 * rvbn;
  const float u2 = __fmul_rn(u, u), v2 = __fmul_rn(v, v), uv = u * v;
  const float plane0 = __fmul_rn(v2 + 1.0f, w0) - __fmul_rn(uv, w1) - __fmul_rn(u, w2);
  const float plane1 = __fmul_rn(-uv, w0) + __fmul_rn(u2 + 1.0f, w1) - __fmul_rn(v, w2);
  const float nl = u2 + v2 + 1.0f;
  const float l = sqrtf(__fmul_rn(tx, tx) + __fmul_rn(ty, ty) + __fmul_rn(z, z));
  const float inv_nlfx = 1.0f / (nl * cam.fx), inv_nlfy = 1.0f / (nl * cam.fy);
  float cp[3][2] = {
      {(__fmul_rn(-(v2 + 1.0f), z) + __fmul_rn(plane0, tx)) * inv_nlfx,
       (__fmul_rn(uv, z) + __fmul_rn(plane1, tx)) * inv_nlfy},
      {(__fmul_rn(uv, z) + __fmul_rn(plane0, ty)) * inv_nlfx,
       (__fmul_rn(-(u2 + 1.0f), z) + __fmul_rn(plane1, ty)) * inv_nlfy},
      {(tx + __fmul_rn(plane0, z)) * inv_nlfx, (ty + __fmul_rn(plane1, z)) * inv_nlfy}};
  float rp0 = plane0 * l * inv_nlfx, rp1 = plane1 * l * inv_nlfy;
  const float factor = l / nl;
  const float cn0 = __fmul_rn(-plane0 * factor, inv_z) - tx / l;
  const float cn1 = __fmul_rn(-plane1 * factor, inv_z) - ty / l;
  const float cn2 =
      __fmul_rn((__fmul_rn(plane0, tx) + __fmul_rn(plane1, ty)) * factor, inv_z2) - z / l;
  const float rn = 1.0f / sqrtf(fmaxf(
      sum3(__fmul_rn(cn0, cn0), __fmul_rn(cn1, cn1), __fmul_rn(cn2, cn2)), 1e-30f));
  float nrm[3] = {cn0 * rn, cn1 * rn, cn2 * rn};
  if (!plane_ok) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nrm[k] = 0.f;
      cp[k][0] = cp[k][1] = 0.f;
    }
    rp0 = rp1 = 0.f;
  }

  // ---- SH colour at the active degree (forward.cu:23-74) ----
  float d[3] = {p[0] - cam.centre[0], p[1] - cam.centre[1], p[2] - cam.centre[2]};
  const float dn = norm3(d[0], d[1], d[2]);
  float basis[M];
  sh_basis<D>(d[0] / dn, d[1] / dn, d[2] / dn, basis);
  const float* sh_rest = rest + t * REST;
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // PyTorch's sum over the M coefficients (a middle dimension): four
    // accumulators over k mod 4, each in order, then added in order; the
    // bands above the active degree add zeros
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float coeff = k == 0 ? dc[c] : sh_rest[(k - 1) * 3 + c];
      const float y = k >= n_sh ? 0.f : __fmul_rn(basis[k], coeff);
      acc[k % 4] = k < 4 ? y : acc[k % 4] + y;
    }
    rgb[c] = fmaxf(((acc[0] + acc[1]) + acc[2]) + acc[3] + 0.5f, 0.0f);
  }
  const float ts = norm3(pv[0], pv[1], pv[2]);

  float4* f = out.feat + (size_t)i * (N_FEAT / 4);
  f[0] = make_float4(xy0, xy1, c1 * det_inv, -b0 * det_inv);
  f[1] = make_float4(a1 * det_inv, valid ? opac * coef : 0.f, rgb[0], rgb[1]);
  f[2] = make_float4(rgb[2], ts, rp0, rp1);
  f[3] = make_float4(pv[0], pv[1], pv[2], cp[0][0]);
  f[4] = make_float4(cp[1][0], cp[2][0], cp[0][1], cp[1][1]);
  f[5] = make_float4(cp[2][1], nrm[0], nrm[1], nrm[2]);
  out.radius[i] = valid ? radius : 0.0f;
  out.valid[i] = valid;
  out.well[i] = well;

  // ---- inverse ray-space covariance (forward.cu:187-235, the INTE branch) ----
  if constexpr (INV) {
    const float Jr[3][3] = {{j00, 0.f, j02}, {0.f, j11, j12}, {tx / l, ty / l, z / l}};
    float B[3][3], vview[3][3], C[3][3], rc[3][3];
    mul(cam.w2c, cov, B);
    mul_bt(B, cam.w2c, vview);
    mul(Jr, vview, C);
    mul_bt(C, Jr, rc);
    const float reg = well ? 0.f : 1e-6f;
    const float xx = rc[0][0] + reg, xy = rc[0][1], xz = rc[0][2];
    const float yy = rc[1][1] + reg, yz = rc[1][2], zz = rc[2][2] + reg;
    const float cxx = __fmul_rn(yy, zz) - __fmul_rn(yz, yz);
    const float cxy = __fmul_rn(xz, yz) - __fmul_rn(xy, zz);
    const float cxz = __fmul_rn(xy, yz) - __fmul_rn(xz, yy);
    const float cyy = __fmul_rn(xx, zz) - __fmul_rn(xz, xz);
    const float cyz = __fmul_rn(xy, xz) - __fmul_rn(xx, yz);
    const float czz = __fmul_rn(xx, yy) - __fmul_rn(xy, xy);
    const float d3 = __fmul_rn(xx, cxx) + __fmul_rn(xy, cxy) + __fmul_rn(xz, cxz);
    const float rd = d3 == 0.0f ? 0.0f : 1.0f / d3;
    const float inv6[6] = {cxx * rd, cxy * rd, cxz * rd, cyy * rd, cyz * rd, czz * rd};
    float* o = out.invraycov + (size_t)i * 9;
    o[0] = inv6[0];
    o[1] = inv6[1];
    o[2] = inv6[2];
    o[3] = inv6[1];
    o[4] = inv6[3];
    o[5] = inv6[4];
    o[6] = inv6[2];
    o[7] = inv6[4];
    o[8] = inv6[5];
  }
}

template <int D, bool INV>
int launch(const Inputs& in, const Outputs& out, int P, int width, int height, int n_sh,
           float kernel_size, float scale_modifier, cudaStream_t s) {
  const int blocks = (P + NT - 1) / NT;
  preprocess_fwd_kernel<D, INV><<<blocks, NT, 0, s>>>(in, out, P, width, height, n_sh,
                                                      kernel_size, scale_modifier);
  return static_cast<int>(cudaGetLastError());
}

template <bool INV>
int launch_degree(int sh_degree, const Inputs& in, const Outputs& out, int P, int width,
                  int height, int n_sh, float kernel_size, float scale_modifier,
                  cudaStream_t s) {
  switch (sh_degree) {
    case 0: return launch<0, INV>(in, out, P, width, height, n_sh, kernel_size, scale_modifier, s);
    case 1: return launch<1, INV>(in, out, P, width, height, n_sh, kernel_size, scale_modifier, s);
    case 2: return launch<2, INV>(in, out, P, width, height, n_sh, kernel_size, scale_modifier, s);
    default: return launch<3, INV>(in, out, P, width, height, n_sh, kernel_size, scale_modifier, s);
  }
}

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/preprocess.py. The
// camera's R and T are read at their strides (in floats). `sh_degree`
// (0-3) is the state's maximum degree, the layout of f_rest; SH bands up to
// `active_sh_degree` are evaluated. `invraycov` null leaves the inverse
// ray-space covariance out. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int radegs_preprocess_fwd(const void* xyz, const void* f_dc, const void* f_rest,
                                     const void* scaling, const void* rotation,
                                     const void* opacity, const void* filter_3d,
                                     const void* active, const void* R, const void* T,
                                     const void* fovx, const void* fovy, void* feat,
                                     void* radius, void* valid, void* well, void* invraycov,
                                     int r_stride0, int r_stride1, int t_stride, int P,
                                     int width, int height, int sh_degree,
                                     int active_sh_degree, float kernel_size,
                                     float scale_modifier, void* stream) {
  if (sh_degree < 0 || sh_degree > 3 || active_sh_degree < 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return 0;
  const Inputs in{static_cast<const float*>(xyz),     static_cast<const float*>(f_dc),
                  static_cast<const float*>(f_rest),  static_cast<const float*>(scaling),
                  static_cast<const float4*>(rotation), static_cast<const float*>(opacity),
                  static_cast<const float*>(filter_3d), static_cast<const bool*>(active),
                  static_cast<const float*>(R),       static_cast<const float*>(T),
                  static_cast<const float*>(fovx),    static_cast<const float*>(fovy),
                  r_stride0, r_stride1, t_stride};
  const Outputs out{static_cast<float4*>(feat), static_cast<float*>(radius),
                    static_cast<bool*>(valid), static_cast<bool*>(well),
                    static_cast<float*>(invraycov)};
  const int n_sh = (active_sh_degree + 1) * (active_sh_degree + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (invraycov != nullptr) {
    return launch_degree<true>(sh_degree, in, out, P, width, height, n_sh, kernel_size,
                               scale_modifier, s);
  }
  return launch_degree<false>(sh_degree, in, out, P, width, height, n_sh, kernel_size,
                              scale_modifier, s);
}
