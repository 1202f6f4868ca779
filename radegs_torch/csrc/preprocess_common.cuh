// What the preprocess kernels (preprocess_fwd.cu, preprocess_bwd.cu) share:
// the per-Gaussian table's column positions, the state's inputs, the
// camera's derived terms, and the small products and reductions in the
// order PyTorch's kernels take them, so the backward recomputes the
// forward's bits. Compiles for the host too (g++ -x c++ -ffp-contract=off),
// for the host build of preprocess_bwd.cu.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define UNROLL _Pragma("unroll")
#else
#define HD inline
#define UNROLL
struct float4 {
  float x, y, z, w;
};
#endif

namespace radegs {

// The per-Gaussian table, N_FEAT floats a row: the one layout, owned by
// radegs_torch/core/projection.py (COLUMNS), which the blend kernels read
// (blend_common.cuh) and the blend's backward writes its gradient in.
enum TableColumn : int {
  COL_XY = 0,            // 2
  COL_CONIC = 2,         // 3: a, b, c
  COL_OPACITY = 5,       // 0 where the row is not valid
  COL_RGB = 6,           // 3
  COL_TS = 9,
  COL_RAY_PLANE = 10,    // 2
  COL_VIEW_POINT = 12,   // 3; its z is the depth
  COL_CAMERA_PLANE = 15, // 6: camera_plane[:, :, 0] then camera_plane[:, :, 1]
  COL_NORMAL = 21,       // 3
  N_FEAT = 24
};

constexpr float NEAR_PLANE = 0.2f;  // auxiliary.h:21
constexpr float EIG_EPS = 1e-8f;    // forward.cu:142

constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f, SH_C2_1 = -1.0925484305920792f,
                SH_C2_2 = 0.31539156525252005f, SH_C2_3 = -1.0925484305920792f,
                SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f, SH_C3_1 = 2.890611442640554f,
                SH_C3_2 = -0.4570457994644658f, SH_C3_3 = 0.3731763325901154f,
                SH_C3_4 = -0.4570457994644658f, SH_C3_5 = 1.445305721320277f,
                SH_C3_6 = -0.5900435899266435f;

// a product that the compiler never contracts into an FMA, and an FMA (the
// host build compiles with -ffp-contract=off)
HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
HD float fma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

struct Inputs {
  const float* xyz;        // (P, 3)
  const float* f_dc;       // (P, 1, 3)
  const float* f_rest;     // (P, M - 1, 3)
  const float* scaling;    // (P, 3) log-scales
  const float4* rotation;  // (P, 4) unnormalised (w, x, y, z)
  const float* opacity;    // (P, 1) logit
  const float* filter_3d;  // (P, 1)
  const bool* active;      // (P,)
  const float* R;          // (3, 3) camera-to-world rotation, strides r0, r1
  const float* T;          // (3,) world-to-camera translation, stride t0
  const float* fovx;       // 0-d
  const float* fovy;
  int r0, r1, t0;
};

// The camera's derived terms (core/camera.py), as PyTorch computes them.
struct Cam {
  float w2c[3][3];  // rows of the world-to-camera rotation (R^T)
  float t[3];
  float proj[2][4];  // rows 0 and 1 of full_proj = projection @ world_view: a scaled w2c row and t
  float centre[3];   // -(R @ T)
  float fx, fy, limx, limy, width, height;
};

HD Cam make_cam(const Inputs& in, int width, int height) {
  Cam c;
  const float tanx = tanf(mul_rn(*in.fovx, 0.5f)), tany = tanf(mul_rn(*in.fovy, 0.5f));
  float R[9], T[3];
  UNROLL
  for (int k = 0; k < 9; ++k) R[k] = in.R[(k / 3) * in.r0 + (k % 3) * in.r1];
  UNROLL
  for (int k = 0; k < 3; ++k) T[k] = in.T[k * in.t0];
  // `width / x` and `1.0 / x` of a tensor x are PyTorch's reciprocal(x) * width
  c.fx = (float)width * (1.0f / (2.0f * tanx));
  c.fy = (float)height * (1.0f / (2.0f * tany));
  c.limx = 1.3f * tanx;
  c.limy = 1.3f * tany;
  const float inv_tx = 1.0f / tanx, inv_ty = 1.0f / tany;
  UNROLL
  for (int i = 0; i < 3; ++i) {
    UNROLL
    for (int j = 0; j < 3; ++j) c.w2c[i][j] = R[3 * j + i];
    c.t[i] = T[i];
    c.centre[i] = -(mul_rn(R[3 * i], T[0]) + mul_rn(R[3 * i + 1], T[1]) +
                    mul_rn(R[3 * i + 2], T[2]));
  }
  UNROLL
  for (int j = 0; j < 3; ++j) {
    c.proj[0][j] = inv_tx * c.w2c[0][j];
    c.proj[1][j] = inv_ty * c.w2c[1][j];
  }
  c.proj[0][3] = inv_tx * T[0];
  c.proj[1][3] = inv_ty * T[1];
  c.width = (float)width;
  c.height = (float)height;
  return c;
}

// PyTorch's sum over a last dimension of 3 (x.sum(-1)): lanes 0 and 2, then 1
HD float sum3(float x0, float x1, float x2) { return (x0 + x2) + x1; }

// torch.linalg.vector_norm over a last dimension of 3 and of 4
HD float norm3(float x0, float x1, float x2) {
  return sqrtf(sum3(mul_rn(x0, x0), mul_rn(x1, x1), mul_rn(x2, x2)));
}
HD float norm4(float x0, float x1, float x2, float x3) {
  return sqrtf((mul_rn(x0, x0) + mul_rn(x2, x2)) + (mul_rn(x1, x1) + mul_rn(x3, x3)));
}

// u^T M v as core/projection.py _quad: the products (u_i M_ik) v_k, summed
// over their row-major index y in PyTorch's order for a (P, 3, 3).sum((1, 2))
HD float quad(const float (&u)[3], const float (&M)[3][3], const float (&v)[3]) {
  float y[9];
  UNROLL
  for (int i = 0; i < 3; ++i) {
    UNROLL
    for (int k = 0; k < 3; ++k) y[3 * i + k] = mul_rn(u[i] * M[i][k], v[k]);
  }
  return (((y[0] + y[8]) + y[4]) + (y[2] + y[6])) + ((y[1] + y[5]) + (y[3] + y[7]));
}

// a (P,3) x (3,3)^T product plus a bias, as cuBLAS and the add give it:
// w . x by FMAs over k in order, then + t
HD float affine(const float* w, const float (&x)[3], float t) {
  return fma_rn(w[2], x[2], fma_rn(w[1], x[1], mul_rn(w[0], x[0]))) + t;
}

// A B^T for 3x3 A, B: core/projection.py _bmm3(A, B.transpose), whose
// operand layout has PyTorch sum over j as sum3 does
HD void mul_bt(const float (&A)[3][3], const float (&B)[3][3], float (&C)[3][3]) {
  UNROLL
  for (int i = 0; i < 3; ++i) {
    UNROLL
    for (int k = 0; k < 3; ++k) {
      C[i][k] = sum3(mul_rn(A[i][0], B[k][0]), mul_rn(A[i][1], B[k][1]),
                     mul_rn(A[i][2], B[k][2]));
    }
  }
}

// A B for 3x3 A, B: _bmm3(A, B) of contiguous operands, a sum over j in order
HD void mul(const float (&A)[3][3], const float (&B)[3][3], float (&C)[3][3]) {
  UNROLL
  for (int i = 0; i < 3; ++i) {
    UNROLL
    for (int k = 0; k < 3; ++k) {
      C[i][k] = mul_rn(A[i][0], B[0][k]) + mul_rn(A[i][1], B[1][k]) + mul_rn(A[i][2], B[2][k]);
    }
  }
}

// the screen-space radius (forward.cu:391-398) of the filtered 2D covariance
// (a1, b0, c1) with determinant det; the row is valid in front of the near
// plane where det != 0 and this is > 0
HD float screen_radius(float a1, float c1, float det) {
  const float mid = mul_rn(0.5f, a1 + c1);
  const float disc = sqrtf(fmaxf(mul_rn(mid, mid) - det, 0.1f));
  const float lam_max = fmaxf(mid + disc, mid - disc);
  return ceilf(3.0f * sqrtf(fmaxf(lam_max, 0.0f)));
}

// the real SH basis of degree D at unit direction (x, y, z) (core/sh.py sh_basis)
template <int D>
HD void sh_basis(float x, float y, float z, float (&b)[(D + 1) * (D + 1)]) {
  b[0] = SH_C0;
  if constexpr (D >= 1) {
    b[1] = -SH_C1 * y;
    b[2] = SH_C1 * z;
    b[3] = -SH_C1 * x;
  }
  if constexpr (D >= 2) {
    const float xx = mul_rn(x, x), yy = mul_rn(y, y), zz = mul_rn(z, z);
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * (mul_rn(2.0f, zz) - xx - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if constexpr (D >= 3) {
      b[9] = SH_C3_0 * y * (mul_rn(3.0f, xx) - yy);
      b[10] = SH_C3_1 * xy * z;
      b[11] = SH_C3_2 * y * (mul_rn(4.0f, zz) - xx - yy);
      b[12] = SH_C3_3 * z * (mul_rn(2.0f, zz) - mul_rn(3.0f, xx) - mul_rn(3.0f, yy));
      b[13] = SH_C3_4 * x * (mul_rn(4.0f, zz) - xx - yy);
      b[14] = SH_C3_5 * z * (xx - yy);
      b[15] = SH_C3_6 * x * (xx - mul_rn(3.0f, yy));
    }
  }
}

}  // namespace radegs
