// Preprocess backward of RaDe-GS on Hopper (sm_90a), for training: the
// gradient of csrc/preprocess_fwd.cu's outputs with respect to the state's
// six raw parameter tensors, in one pass over the rows. The chain is the one
// autograd takes through the plain version (ops/preprocess.py
// preprocess_torch: the state's getters and core/projection.py
// preprocess_gaussians): the activations (exp of the log-scales, sigmoid of
// the opacity logit, the quaternion normalised), the Mip 3D filter fused into
// scale and opacity (fuse_3d_filter; its product's gradient is the product of
// the other two factors, with no host read of a zero test), the active mask,
// the NDC projection, the near cull and cone clamp of the EWA covariance, the
// 2D filter's opacity compensation, the conic, RaDe-GS's ray-space planes,
// camera plane and normal (the smallest-axis branch where the covariance is
// ill-conditioned), the centre's ray distance and depth, and SH colour at the
// state's active degree with its dependence on the centre through the view
// direction (reference backward.cu preprocessCUDA, computeCov2D, the SH pass).
//
// Replaces no TPU kernel: the JAX package differentiates its XLA preprocess
// with autograd. Under PyTorch that chain is ~2,000 small kernels a step over
// the state's rows, most of a training step's time.
//
// Design:
//   - one thread a row, NT rows a block, the SH degree a template parameter;
//     the row recomputes the forward's intermediates from its raw parameters
//     with the forward kernel's own arithmetic (the same formulas, rounding
//     and reduction orders), so every branch — near cull, cone clamp, the
//     2D filter's cut, nonsingular, well-conditioned and its smallest axis,
//     plane_ok, the colour's clamp — is decided on the forward's bits, which
//     are the plain version's on the card; nothing is saved between the two;
//   - at each clamp, where, max / min tie and branch the gradient is the one
//     autograd gives: the clamps pass it at their bounds (clamp and
//     clamp_min are inclusive), where routes it to the branch taken, the
//     first smallest scale takes the ill-conditioned branch's gradient; the
//     opacity column's is zero where the row is not valid, as the column
//     is; an inactive row gets zeros;
//   - the incoming gradient is the table's, one row of N_FEAT floats a row
//     (preprocess_common.cuh), read where autograd hands it over at its row
//     stride (a view of the blend's gradient buffer); none (null) reads as
//     zero;
//   - what bounds it on an H100 is bytes: an active row reads its 59
//     parameter floats (SH degree 3), its 3D filter and active flag and up to
//     24 cotangent floats, and writes 59 gradient floats (~580 B); the block's
//     rows of f_rest (45 floats a row, not 16-byte aligned) are one run,
//     staged through shared memory as 16-byte loads, and their gradients go
//     back out through the same buffer as 16-byte stores.
//
// The forward's helpers (the camera's terms, the small products and
// reductions, the SH basis) are preprocess_common.cuh's, shared with
// preprocess_fwd.cu. The row's arithmetic (row_backward) compiles for the
// host too: without nvcc the file builds as C++ (g++ -x c++
// -ffp-contract=off) into a library with the same C entry that loops over
// the rows on the CPU, so the tests can hold this source to autograd on a
// machine without a card.
//
// Output, for rows [0, P): the gradients of xyz (P, 3), f_dc (P, 1, 3),
// f_rest (P, M - 1, 3), scaling (P, 3), rotation (P, 4) and opacity (P, 1),
// contiguous, float32, in the parameters' own layouts.

#include "preprocess_common.cuh"

using namespace radegs;

namespace {

constexpr int NT = 128;  // rows (threads) a block

struct Grads {
  float* xyz;
  float* f_dc;
  float* f_rest;
  float* scaling;
  float4* rotation;
  float* opacity;
};

// one row's incoming gradient: its row of the table's gradient
struct RowCot {
  float xy[2], vp[3], conic[3], opac, rgb[3], cp[3][2], rp[2], nrm[3], ts;
};

// one row's gradient (f_rest's goes back through the coefficients' buffer)
struct RowGrad {
  float xyz[3], dc[3], scaling[3], rot[4], opacity;
};

// the gradient of the unit direction (x, y, z) from that of the basis, gb
template <int D>
HD void sh_basis_backward(float x, float y, float z, const float (&gb)[(D + 1) * (D + 1)],
                          float (&gd)[3]) {
  gd[0] = gd[1] = gd[2] = 0.f;
  if constexpr (D >= 1) {
    gd[0] -= SH_C1 * gb[3];
    gd[1] -= SH_C1 * gb[1];
    gd[2] += SH_C1 * gb[2];
  }
  if constexpr (D >= 2) {
    gd[0] += SH_C2_0 * y * gb[4] - 2.f * SH_C2_2 * x * gb[6] + SH_C2_3 * z * gb[7] +
             2.f * SH_C2_4 * x * gb[8];
    gd[1] += SH_C2_0 * x * gb[4] + SH_C2_1 * z * gb[5] - 2.f * SH_C2_2 * y * gb[6] -
             2.f * SH_C2_4 * y * gb[8];
    gd[2] += SH_C2_1 * y * gb[5] + 4.f * SH_C2_2 * z * gb[6] + SH_C2_3 * x * gb[7];
    if constexpr (D >= 3) {
      const float xx = x * x, yy = y * y, zz = z * z;
      gd[0] += 6.f * SH_C3_0 * x * y * gb[9] + SH_C3_1 * y * z * gb[10] -
               2.f * SH_C3_2 * x * y * gb[11] - 6.f * SH_C3_3 * x * z * gb[12] +
               SH_C3_4 * (4.f * zz - 3.f * xx - yy) * gb[13] + 2.f * SH_C3_5 * x * z * gb[14] +
               3.f * SH_C3_6 * (xx - yy) * gb[15];
      gd[1] += 3.f * SH_C3_0 * (xx - yy) * gb[9] + SH_C3_1 * x * z * gb[10] +
               SH_C3_2 * (4.f * zz - xx - 3.f * yy) * gb[11] - 6.f * SH_C3_3 * y * z * gb[12] -
               2.f * SH_C3_4 * x * y * gb[13] - 2.f * SH_C3_5 * y * z * gb[14] -
               6.f * SH_C3_6 * x * y * gb[15];
      gd[2] += SH_C3_1 * x * y * gb[10] + 8.f * SH_C3_2 * y * z * gb[11] +
               SH_C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * gb[12] +
               8.f * SH_C3_4 * x * z * gb[13] + SH_C3_5 * (xx - yy) * gb[14];
    }
  }
}

// The gradient of R diag(s) R^T with respect to R and s, from its gradient G:
// gR += (G + G^T) R diag(s), gs_j += sum_ik G_ik R_ij R_kj.
HD void rdr_backward(const float (&G)[3][3], const float (&R)[3][3], const float (&s)[3],
                     float (&gR)[3][3], float (&gs)[3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
      for (int k = 0; k < 3; ++k) acc += (G[i][k] + G[k][i]) * R[k][j];
      gR[i][j] += acc * s[j];
    }
  }
  for (int j = 0; j < 3; ++j) {
    float acc = 0.f;
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) acc += G[i][k] * R[i][j] * R[k][j];
    }
    gs[j] += acc;
  }
}

// One active row: its forward recomputed, then its gradient. `rest` holds the
// row's (M - 1) x 3 SH coefficients and receives their gradient.
template <int D>
HD void row_backward(const Cam& cam, const float (&p)[3], const float (&ls)[3],
                     const float (&dc)[3], float* rest, const float (&q4)[4], float op_logit,
                     float filt, int n_sh, float kernel_size, float scale_modifier,
                     const RowCot& g, RowGrad& o) {
  constexpr int M = (D + 1) * (D + 1);

  // ======== the forward (csrc/preprocess_fwd.cu, operation for operation) ========
  // activations and the fused 3D filter
  float s[3], s2[3], s2f[3], r[3], scale[3];
  const float f2 = mul_rn(filt, filt);
  for (int k = 0; k < 3; ++k) {
    s[k] = expf(ls[k]);
    s2[k] = mul_rn(s[k], s[k]);
    s2f[k] = s2[k] + f2;
    r[k] = s2[k] / s2f[k];
    scale[k] = sqrtf(s2f[k]);
  }
  const float sig = 1.0f / (1.0f + expf(-op_logit));
  const float coef3 = sqrtf((r[0] * r[2]) * r[1]);
  const float opac = sig * coef3;
  const float qn = norm4(q4[0], q4[1], q4[2], q4[3]);
  const float qh[4] = {q4[0] / qn, q4[1] / qn, q4[2] / qn, q4[3] / qn};
  const float qr = qh[0], qx = qh[1], qy = qh[2], qz = qh[3];

  // world covariance, its inverse, the smallest axis
  const float Rq[3][3] = {
      {1.f - mul_rn(2.f, mul_rn(qy, qy) + mul_rn(qz, qz)), 2.f * (mul_rn(qx, qy) - mul_rn(qr, qz)),
       2.f * (mul_rn(qx, qz) + mul_rn(qr, qy))},
      {2.f * (mul_rn(qx, qy) + mul_rn(qr, qz)), 1.f - mul_rn(2.f, mul_rn(qx, qx) + mul_rn(qz, qz)),
       2.f * (mul_rn(qy, qz) - mul_rn(qr, qx))},
      {2.f * (mul_rn(qx, qz) - mul_rn(qr, qy)), 2.f * (mul_rn(qy, qz) + mul_rn(qr, qx)),
       1.f - mul_rn(2.f, mul_rn(qx, qx) + mul_rn(qy, qy))}};
  float sm[3], s2m[3], rinv[3];
  for (int k = 0; k < 3; ++k) {
    sm[k] = scale[k] * scale_modifier;
    s2m[k] = sm[k] * sm[k];
    rinv[k] = 1.0f / fmaxf(s2m[k], 1e-30f);
  }
  float RS[3][3], RSi[3][3];
  for (int a = 0; a < 3; ++a) {
    for (int k = 0; k < 3; ++k) {
      RS[a][k] = Rq[a][k] * s2m[k];
      RSi[a][k] = Rq[a][k] * rinv[k];
    }
  }
  float cov[3][3], vrk[3][3], mvax[3];
  mul_bt(RS, Rq, cov);
  int arg = 0;  // the first minimum
  if (s2m[1] < s2m[arg]) arg = 1;
  if (s2m[2] < s2m[arg]) arg = 2;
  const bool well = s2m[arg] > EIG_EPS;
  for (int a = 0; a < 3; ++a) mvax[a] = arg == 0 ? Rq[a][0] : (arg == 1 ? Rq[a][1] : Rq[a][2]);
  if (well) {
    mul_bt(RSi, Rq, vrk);
  } else {
    for (int a = 0; a < 3; ++a) {
      for (int k = 0; k < 3; ++k) vrk[a][k] = mvax[a] * mvax[k];
    }
  }

  // view transform, near cull, NDC projection
  float pv[3];
  for (int a = 0; a < 3; ++a) pv[a] = affine(cam.w2c[a], p, cam.t[a]);
  const bool in_front = pv[2] > NEAR_PLANE;
  const float z = in_front ? pv[2] : 1.0f;
  const float hx = affine(cam.proj[0], p, cam.proj[0][3]);
  const float hy = affine(cam.proj[1], p, cam.proj[1][3]);
  const float pw = 1.0f / (pv[2] + 1e-7f);

  // EWA cov2D with the cone clamp and the 2D filter
  const float rx = pv[0] / z, ry = pv[1] / z;
  const float u = fminf(fmaxf(rx, -cam.limx), cam.limx);
  const float v = fminf(fmaxf(ry, -cam.limy), cam.limy);
  const float tx = mul_rn(u, z), ty = mul_rn(v, z);
  const float inv_z = 1.0f / z;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = cam.fx * inv_z, j02 = -cam.fx * tx * inv_z2;
  const float j11 = cam.fy * inv_z, j12 = -cam.fy * ty * inv_z2;
  float m0[3], m1[3];
  for (int k = 0; k < 3; ++k) {
    m0[k] = mul_rn(j00, cam.w2c[0][k]) + mul_rn(j02, cam.w2c[2][k]);
    m1[k] = mul_rn(j11, cam.w2c[1][k]) + mul_rn(j12, cam.w2c[2][k]);
  }
  const float a0 = quad(m0, cov, m0), b0 = quad(m0, cov, m1), c0 = quad(m1, cov, m1);
  const float det0 = fmaxf(mul_rn(a0, c0) - mul_rn(b0, b0), 1e-6f);
  const float a1 = a0 + kernel_size, c1 = c0 + kernel_size;
  const float det = mul_rn(a1, c1) - mul_rn(b0, b0);
  const float det1m = fmaxf(det, 1e-6f);
  const bool cut = det0 <= 1e-6f || det1m <= 1e-6f;  // the 2D filter's coef is 0
  const float coef = cut ? 0.f : sqrtf(det0 / (det1m + 1e-6f) + 1e-6f);
  const bool nonsingular = det != 0.0f;
  const float det_inv = 1.0f / (nonsingular ? det : 1.0f);
  const bool valid = in_front && nonsingular && screen_radius(a1, c1, det) > 0.0f;

  // ray-space planes and normal
  float A[3][3], cam_inv[3][3];
  mul(cam.w2c, vrk, A);
  mul_bt(A, cam.w2c, cam_inv);
  float mv[3];
  for (int a = 0; a < 3; ++a) {
    mv[a] = sum3(mul_rn(cam_inv[a][0], u), mul_rn(cam_inv[a][1], v), cam_inv[a][2]);
  }
  const float mn2 = sum3(mul_rn(mv[0], mv[0]), mul_rn(mv[1], mv[1]), mul_rn(mv[2], mv[2]));
  const float mn_norm = sqrtf(mn2);
  const float rmn = 1.0f / sqrtf(fmaxf(mn2, 1e-30f));
  const bool plane_ok = mn_norm > 1e-20f && isfinite(mn_norm);
  const float n0 = mul_rn(mv[0], rmn), n1 = mul_rn(mv[1], rmn), n2 = mul_rn(mv[2], rmn);
  const float vbn = sum3(mul_rn(n0, u), mul_rn(n1, v), n2);
  const float rvbn = 1.0f / fmaxf(vbn, 1e-7f);
  const float w0 = n0 * rvbn, w1 = n1 * rvbn, w2 = n2 * rvbn;
  const float u2 = mul_rn(u, u), v2 = mul_rn(v, v), uv = u * v;
  const float plane0 = mul_rn(v2 + 1.0f, w0) - mul_rn(uv, w1) - mul_rn(u, w2);
  const float plane1 = mul_rn(-uv, w0) + mul_rn(u2 + 1.0f, w1) - mul_rn(v, w2);
  const float nl = u2 + v2 + 1.0f;
  const float l = sqrtf(mul_rn(tx, tx) + mul_rn(ty, ty) + mul_rn(z, z));
  const float inv_nlfx = 1.0f / (nl * cam.fx), inv_nlfy = 1.0f / (nl * cam.fy);
  const float factor = l / nl;
  const float pt = mul_rn(plane0, tx) + mul_rn(plane1, ty);
  const float cn[3] = {mul_rn(-plane0 * factor, inv_z) - tx / l,
                       mul_rn(-plane1 * factor, inv_z) - ty / l,
                       mul_rn(pt * factor, inv_z2) - z / l};
  const float cn2 = sum3(mul_rn(cn[0], cn[0]), mul_rn(cn[1], cn[1]), mul_rn(cn[2], cn[2]));
  const float rn = 1.0f / sqrtf(fmaxf(cn2, 1e-30f));

  // SH colour at the active degree, before its clamp
  const float d[3] = {p[0] - cam.centre[0], p[1] - cam.centre[1], p[2] - cam.centre[2]};
  const float dn = norm3(d[0], d[1], d[2]);
  const float dir[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
  float basis[M];
  sh_basis<D>(dir[0], dir[1], dir[2], basis);
  float raw[3];
  for (int c = 0; c < 3; ++c) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < M; ++k) {
      const float coeff = k == 0 ? dc[c] : rest[(k - 1) * 3 + c];
      const float y = k >= n_sh ? 0.f : mul_rn(basis[k], coeff);
      acc[k % 4] = k < 4 ? y : acc[k % 4] + y;
    }
    raw[c] = ((acc[0] + acc[1]) + acc[2]) + acc[3] + 0.5f;
  }
  const float ts = norm3(pv[0], pv[1], pv[2]);

  // ======== the backward ========
  // Each reciprocal, division and root differentiates as autograd's formula
  // does (-g (r r) for r = 1 / x; -g ((a / b) / b) for a / b; g / (2 y) for
  // y = sqrt(x)) but for two sums whose terms cancel, taken in closed form
  // (the 2D filter's compensation, the fused filter's ratio).
  // the view-space centre: view_point (its z is the depth) and ts = |pv|
  // (autograd's norm backward is 0 where the norm is)
  float g_pv[3] = {g.vp[0], g.vp[1], g.vp[2]};
  if (ts != 0.f) {
    const float k = g.ts / ts;
    for (int a = 0; a < 3; ++a) g_pv[a] += pv[a] * k;
  }

  // xy = ((h * pw + 1) * size - 1) / 2, pw = 1 / (pv_z + 1e-7): full_proj's w
  // row is world_view's z row
  float g_p[3];
  {
    const float gx = 0.5f * cam.width * g.xy[0], gy = 0.5f * cam.height * g.xy[1];
    const float g_pw = gx * hx + gy * hy;
    for (int j = 0; j < 3; ++j) g_p[j] = gx * pw * cam.proj[0][j] + gy * pw * cam.proj[1][j];
    g_pv[2] -= g_pw * (pw * pw);
  }

  // conic = (c1, -b0, a1) / det where det != 0; det = a1 c1 - b0^2
  float g_a1 = g.conic[2] * det_inv, g_c1 = g.conic[0] * det_inv;
  float g_b0 = -g.conic[1] * det_inv;
  if (nonsingular) {
    const float g_det =
        -(g.conic[0] * c1 - g.conic[1] * b0 + g.conic[2] * a1) * (det_inv * det_inv);
    g_a1 += g_det * c1;
    g_c1 += g_det * a1;
    g_b0 -= 2.f * b0 * g_det;
  }
  // the opacity column opac * coef, 0 where the row is not valid; coef =
  // sqrt(det0 / (det1m + 1e-6) + 1e-6) where the 2D filter keeps it, with
  // det0 and det1m past their clamps there
  const float g_col = valid ? g.opac : 0.f;
  const float g_opac = g_col * coef;
  float g_a0 = 0.f, g_c0 = 0.f;
  if (!cut) {
    // x = det0 / den + 1e-6 with den = det1m + 1e-6, both clamps passing:
    // dx/da0 = (c0 / den) - det0 c1 / den^2 = (c0 gap - det0 k) / den^2 with
    // k the kernel size and gap = den - det0 = k (a0 + c0 + k) + 1e-6 (the
    // same for c0; dx/db0 = -2 b0 gap / den^2), in the forms free of the two
    // terms' cancellation
    const float den = det1m + 1e-6f;
    const float gap = kernel_size * (a0 + c0 + kernel_size) + 1e-6f;
    const float g_x = g_col * opac / (2.f * coef) / (den * den);
    g_a0 += g_x * (c0 * gap - det0 * kernel_size);
    g_c0 += g_x * (a0 * gap - det0 * kernel_size);
    g_b0 -= 2.f * b0 * gap * g_x;
  }
  g_a0 += g_a1;  // a1 = a0 + kernel_size
  g_c0 += g_c1;

  // a0, b0, c0 = m0^T C m0, m0^T C m1, m1^T C m1
  float g_cov[3][3], g_m0[3], g_m1[3];
  for (int i = 0; i < 3; ++i) {
    float Cm0 = 0.f, CTm0 = 0.f, Cm1 = 0.f, CTm1 = 0.f;
    for (int k = 0; k < 3; ++k) {
      Cm0 += cov[i][k] * m0[k];
      CTm0 += cov[k][i] * m0[k];
      Cm1 += cov[i][k] * m1[k];
      CTm1 += cov[k][i] * m1[k];
    }
    g_m0[i] = g_a0 * (Cm0 + CTm0) + g_b0 * Cm1;
    g_m1[i] = g_b0 * CTm0 + g_c0 * (Cm1 + CTm1);
    for (int k = 0; k < 3; ++k) {
      g_cov[i][k] = g_a0 * m0[i] * m0[k] + g_b0 * m0[i] * m1[k] + g_c0 * m1[i] * m1[k];
    }
  }
  // rows of M = J W: m0 = j00 W0 + j02 W2, m1 = j11 W1 + j12 W2
  float g_j00 = 0.f, g_j02 = 0.f, g_j11 = 0.f, g_j12 = 0.f;
  for (int k = 0; k < 3; ++k) {
    g_j00 += g_m0[k] * cam.w2c[0][k];
    g_j02 += g_m0[k] * cam.w2c[2][k];
    g_j11 += g_m1[k] * cam.w2c[1][k];
    g_j12 += g_m1[k] * cam.w2c[2][k];
  }
  float g_inv_z = cam.fx * g_j00 + cam.fy * g_j11;
  float g_inv_z2 = -cam.fx * tx * g_j02 - cam.fy * ty * g_j12;
  float g_tx = -cam.fx * inv_z2 * g_j02, g_ty = -cam.fy * inv_z2 * g_j12;
  float g_u = 0.f, g_v = 0.f, g_z = 0.f;

  // the planes, camera plane and normal (zeroed by a where unless plane_ok)
  float g_vrk[3][3] = {};
  if (plane_ok) {
    // normal = cn / sqrt(max(|cn|^2, 1e-30))
    float g_cn[3];
    float g_rn = 0.f;
    for (int a = 0; a < 3; ++a) {
      g_cn[a] = g.nrm[a] * rn;
      g_rn += g.nrm[a] * cn[a];
    }
    if (cn2 >= 1e-30f) {
      const float g_cn2 = -g_rn * (rn * rn) / (2.f * sqrtf(cn2));
      for (int a = 0; a < 3; ++a) g_cn[a] += 2.f * cn[a] * g_cn2;
    }
    // cn0 = -plane0 factor / z - tx / l, cn1 likewise, cn2 = pt factor / z^2 - z / l
    float g_plane0 = -g_cn[0] * factor * inv_z + g_cn[2] * tx * factor * inv_z2;
    float g_plane1 = -g_cn[1] * factor * inv_z + g_cn[2] * ty * factor * inv_z2;
    const float g_factor = -(g_cn[0] * plane0 + g_cn[1] * plane1) * inv_z + g_cn[2] * pt * inv_z2;
    g_inv_z -= (g_cn[0] * plane0 + g_cn[1] * plane1) * factor;
    g_inv_z2 += g_cn[2] * pt * factor;
    g_tx += -g_cn[0] / l + g_cn[2] * plane0 * factor * inv_z2;
    g_ty += -g_cn[1] / l + g_cn[2] * plane1 * factor * inv_z2;
    g_z -= g_cn[2] / l;
    float g_l = g_cn[0] * ((tx / l) / l) + g_cn[1] * ((ty / l) / l) + g_cn[2] * ((z / l) / l) +
                g_factor / nl;
    float g_nl = -g_factor * factor / nl;
    // ray_plane = (plane0 l / (nl fx), plane1 l / (nl fy))
    g_plane0 += g.rp[0] * l * inv_nlfx;
    g_plane1 += g.rp[1] * l * inv_nlfy;
    g_l += g.rp[0] * plane0 * inv_nlfx + g.rp[1] * plane1 * inv_nlfy;
    float g_inlfx = g.rp[0] * plane0 * l, g_inlfy = g.rp[1] * plane1 * l;
    // camera_plane: numerators over nl fx (column 0) and nl fy (column 1)
    const float e00 = g.cp[0][0] * inv_nlfx, e10 = g.cp[1][0] * inv_nlfx,
                e20 = g.cp[2][0] * inv_nlfx;
    const float e01 = g.cp[0][1] * inv_nlfy, e11 = g.cp[1][1] * inv_nlfy,
                e21 = g.cp[2][1] * inv_nlfy;
    g_inlfx += g.cp[0][0] * (-(v2 + 1.f) * z + plane0 * tx) + g.cp[1][0] * (uv * z + plane0 * ty) +
               g.cp[2][0] * (tx + plane0 * z);
    g_inlfy += g.cp[0][1] * (uv * z + plane1 * tx) + g.cp[1][1] * (-(u2 + 1.f) * z + plane1 * ty) +
               g.cp[2][1] * (ty + plane1 * z);
    float g_u2 = -e11 * z, g_v2 = -e00 * z, g_uv = (e10 + e01) * z;
    g_z += -e00 * (v2 + 1.f) + e10 * uv + e20 * plane0 + e01 * uv - e11 * (u2 + 1.f) +
           e21 * plane1;
    g_plane0 += e00 * tx + e10 * ty + e20 * z;
    g_plane1 += e01 * tx + e11 * ty + e21 * z;
    g_tx += e00 * plane0 + e20 + e01 * plane1;
    g_ty += e10 * plane0 + e11 * plane1 + e21;
    // inv_nlf = 1 / (nl f); l = |(tx, ty, z)|; nl = u^2 + v^2 + 1
    g_nl -= g_inlfx * inv_nlfx * inv_nlfx * cam.fx + g_inlfy * inv_nlfy * inv_nlfy * cam.fy;
    g_tx += g_l * tx / l;
    g_ty += g_l * ty / l;
    g_z += g_l * z / l;
    g_u2 += g_nl;
    g_v2 += g_nl;
    // plane0 = (v^2 + 1) w0 - uv w1 - u w2, plane1 = -uv w0 + (u^2 + 1) w1 - v w2
    const float g_w[3] = {g_plane0 * (v2 + 1.f) - g_plane1 * uv,
                          -g_plane0 * uv + g_plane1 * (u2 + 1.f), -g_plane0 * u - g_plane1 * v};
    g_v2 += g_plane0 * w0;
    g_u2 += g_plane1 * w1;
    g_uv -= g_plane0 * w1 + g_plane1 * w0;
    g_u -= g_plane0 * w2;
    g_v -= g_plane1 * w2;
    g_u += 2.f * u * g_u2 + v * g_uv;
    g_v += 2.f * v * g_v2 + u * g_uv;
    // w = n / max(n . uvh, 1e-7)
    const float nn[3] = {n0, n1, n2};
    const float uvh[3] = {u, v, 1.f};
    float g_n[3], g_rvbn = 0.f;
    for (int a = 0; a < 3; ++a) {
      g_n[a] = g_w[a] * rvbn;
      g_rvbn += g_w[a] * nn[a];
    }
    if (vbn >= 1e-7f) {
      const float g_vbn = -g_rvbn * (rvbn * rvbn);
      for (int a = 0; a < 3; ++a) g_n[a] += g_vbn * uvh[a];
      g_u += g_vbn * n0;
      g_v += g_vbn * n1;
    }
    // n = mv / sqrt(max(|mv|^2, 1e-30))
    float g_mv[3], g_rmn = 0.f;
    for (int a = 0; a < 3; ++a) {
      g_mv[a] = g_n[a] * rmn;
      g_rmn += g_n[a] * mv[a];
    }
    if (mn2 >= 1e-30f) {
      const float g_mn2 = -g_rmn * (rmn * rmn) / (2.f * sqrtf(mn2));
      for (int a = 0; a < 3; ++a) g_mv[a] += 2.f * mv[a] * g_mn2;
    }
    // mv = cam_inv uvh, cam_inv = W vrk W^T
    float g_ci[3][3];
    for (int a = 0; a < 3; ++a) {
      g_u += g_mv[a] * cam_inv[a][0];
      g_v += g_mv[a] * cam_inv[a][1];
      for (int b = 0; b < 3; ++b) g_ci[a][b] = g_mv[a] * uvh[b];
    }
    float T1[3][3];  // W^T g_ci
    for (int i = 0; i < 3; ++i) {
      for (int b = 0; b < 3; ++b) {
        T1[i][b] = cam.w2c[0][i] * g_ci[0][b] + cam.w2c[1][i] * g_ci[1][b] +
                   cam.w2c[2][i] * g_ci[2][b];
      }
    }
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) {
        g_vrk[i][k] = T1[i][0] * cam.w2c[0][k] + T1[i][1] * cam.w2c[1][k] +
                      T1[i][2] * cam.w2c[2][k];
      }
    }
  }

  // inv_z2 = inv_z^2, inv_z = 1 / z, (tx, ty) = (u, v) z
  g_inv_z += 2.f * inv_z * g_inv_z2;
  g_z -= g_inv_z * (inv_z * inv_z);
  g_u += g_tx * z;
  g_v += g_ty * z;
  g_z += g_tx * u + g_ty * v;
  // the cone clamp passes the gradient at its bounds too; (rx, ry) = pv_xy / z
  const float g_rx = (rx >= -cam.limx && rx <= cam.limx) ? g_u : 0.f;
  const float g_ry = (ry >= -cam.limy && ry <= cam.limy) ? g_v : 0.f;
  g_pv[0] += g_rx / z;
  g_pv[1] += g_ry / z;
  g_z -= g_rx * (rx / z) + g_ry * (ry / z);
  if (in_front) g_pv[2] += g_z;  // z = pv_z in front of the near plane, else 1
  for (int j = 0; j < 3; ++j) {
    g_p[j] += cam.w2c[0][j] * g_pv[0] + cam.w2c[1][j] * g_pv[1] + cam.w2c[2][j] * g_pv[2];
  }

  // cov = R diag(s2m) R^T; vrk = R diag(1 / max(s2m, 1e-30)) R^T where well,
  // else the smallest axis's outer product
  float g_R[3][3] = {}, g_s2m[3] = {0.f, 0.f, 0.f};
  rdr_backward(g_cov, Rq, s2m, g_R, g_s2m);
  if (well) {
    float g_rinv[3] = {0.f, 0.f, 0.f};
    rdr_backward(g_vrk, Rq, rinv, g_R, g_rinv);
    for (int k = 0; k < 3; ++k) {
      if (s2m[k] >= 1e-30f) g_s2m[k] -= g_rinv[k] * (rinv[k] * rinv[k]);
    }
  } else {
    for (int i = 0; i < 3; ++i) {
      float acc = 0.f;
      for (int k = 0; k < 3; ++k) acc += (g_vrk[i][k] + g_vrk[k][i]) * mvax[k];
      g_R[i][arg] += acc;
    }
  }
  // s2m = (scale * modifier)^2; scale = sqrt(s^2 + f^2)
  float g_s2f[3];
  for (int k = 0; k < 3; ++k) g_s2f[k] = g_s2m[k] * 2.f * sm[k] * scale_modifier / (2.f * scale[k]);

  // R of the unit quaternion, then the normalisation
  const float gq[4] = {
      2.f * (-qz * g_R[0][1] + qy * g_R[0][2] + qz * g_R[1][0] - qx * g_R[1][2] - qy * g_R[2][0] +
             qx * g_R[2][1]),
      2.f * (qy * g_R[0][1] + qz * g_R[0][2] + qy * g_R[1][0] - 2.f * qx * g_R[1][1] -
             qr * g_R[1][2] + qz * g_R[2][0] + qr * g_R[2][1] - 2.f * qx * g_R[2][2]),
      2.f * (-2.f * qy * g_R[0][0] + qx * g_R[0][1] + qr * g_R[0][2] + qx * g_R[1][0] +
             qz * g_R[1][2] - qr * g_R[2][0] + qz * g_R[2][1] - 2.f * qy * g_R[2][2]),
      2.f * (-2.f * qz * g_R[0][0] - qr * g_R[0][1] + qx * g_R[0][2] + qr * g_R[1][0] -
             2.f * qz * g_R[1][1] + qy * g_R[1][2] + qx * g_R[2][0] + qy * g_R[2][1])};
  const float qg = qh[0] * gq[0] + qh[1] * gq[1] + qh[2] * gq[2] + qh[3] * gq[3];
  for (int k = 0; k < 4; ++k) o.rot[k] = (gq[k] - qh[k] * qg) / qn;

  // the fused filter: opac = sigmoid(logit) sqrt(r0 r1 r2), r = s^2 / (s^2 + f^2)
  const float g_ratio = g_opac * sig / (2.f * coef3);
  const float g_r[3] = {g_ratio * (r[1] * r[2]), g_ratio * (r[0] * r[2]), g_ratio * (r[0] * r[1])};
  for (int k = 0; k < 3; ++k) {
    // d r / d s^2 = (1 - r) / (s^2 + f^2) = f^2 / (s^2 + f^2)^2, taken in the
    // second form: 0 without a filter, where autograd's two terms cancel
    const float g_s2 = g_r[k] * ((f2 / s2f[k]) / s2f[k]) + g_s2f[k];
    o.scaling[k] = 2.f * s[k] * g_s2 * s[k];  // s = exp(ls)
  }
  o.opacity = g_opac * coef3 * sig * (1.f - sig);

  // SH colour: the clamp at 0 passes the gradient where raw >= 0
  float g_raw[3], g_basis[M];
  for (int c = 0; c < 3; ++c) g_raw[c] = raw[c] >= 0.f ? g.rgb[c] : 0.f;
  for (int c = 0; c < 3; ++c) o.dc[c] = g_raw[c] * basis[0];
  g_basis[0] = 0.f;
  for (int k = 1; k < M; ++k) {
    float gb = 0.f;
    for (int c = 0; c < 3; ++c) {
      float& coeff = rest[(k - 1) * 3 + c];
      gb += g_raw[c] * coeff;
      coeff = k < n_sh ? g_raw[c] * basis[k] : 0.f;
    }
    g_basis[k] = k < n_sh ? gb : 0.f;
  }
  float g_dir[3];
  sh_basis_backward<D>(dir[0], dir[1], dir[2], g_basis, g_dir);
  // dir = d / |d|, d = p - centre
  const float dg = dir[0] * g_dir[0] + dir[1] * g_dir[1] + dir[2] * g_dir[2];
  for (int j = 0; j < 3; ++j) o.xyz[j] = g_p[j] + (g_dir[j] - dir[j] * dg) / dn;
}

// row i of the table's gradient (row stride `stride` floats; null reads as zero)
HD void read_cot(const float* grad, long long stride, size_t i, RowCot& g) {
  float c[N_FEAT] = {};
  if (grad != nullptr) {
    for (int k = 0; k < N_FEAT; ++k) c[k] = grad[(long long)i * stride + k];
  }
  for (int a = 0; a < 2; ++a) {
    g.xy[a] = c[COL_XY + a];
    g.rp[a] = c[COL_RAY_PLANE + a];
  }
  for (int a = 0; a < 3; ++a) {
    g.vp[a] = c[COL_VIEW_POINT + a];
    g.conic[a] = c[COL_CONIC + a];
    g.rgb[a] = c[COL_RGB + a];
    g.nrm[a] = c[COL_NORMAL + a];
    for (int b = 0; b < 2; ++b) g.cp[a][b] = c[COL_CAMERA_PLANE + 3 * b + a];
  }
  g.opac = c[COL_OPACITY];
  g.ts = c[COL_TS];
}

// the gradient rows of row i but f_rest's
HD void write_row(const Grads& o, size_t i, const RowGrad& g) {
  for (int k = 0; k < 3; ++k) {
    o.xyz[i * 3 + k] = g.xyz[k];
    o.f_dc[i * 3 + k] = g.dc[k];
    o.scaling[i * 3 + k] = g.scaling[k];
  }
  o.rotation[i] = float4{g.rot[0], g.rot[1], g.rot[2], g.rot[3]};
  o.opacity[i] = g.opacity;
}

HD void write_zero_row(const Grads& o, size_t i) {
  const RowGrad z = {};
  write_row(o, i, z);
}

#ifdef __CUDACC__

// three blocks an SM: the row's recomputation and chain hold ~210 registers
// at SH degree 3 (two blocks, 8 warps an SM); capped at 168, with a few
// spilled bytes, 12 warps hide more of the reads (0.60 against 0.69 ms at
// 2^21 rows on an H100, the same bits)
template <int D>
__global__ void __launch_bounds__(NT, 3)
preprocess_bwd_kernel(Inputs in, const float* __restrict__ grad, long long grad_stride,
                      Grads out, int P, int width, int height, int n_sh, float kernel_size,
                      float scale_modifier) {
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
  const int n = min(NT, P - row0) * REST;  // f_rest floats of the block's rows
  const int n4 = n / 4;
  float* dst = out.f_rest + (size_t)row0 * REST;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  if (!__syncthreads_or(live)) {  // no active row in the block
    if (i < P) write_zero_row(out, i);
    if constexpr (REST > 0) {
      for (int k = t; k < n4; k += NT) dst4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 4 * n4 + t; k < n; k += NT) dst[k] = 0.f;
    }
    return;
  }

  // the row's own parameters and incoming gradient, in flight while the
  // block stages f_rest
  float p[3], ls[3], dc[3], q[4];
  float op_logit = 0.f, filt = 0.f;
  RowCot g;
  if (live) {
    for (int k = 0; k < 3; ++k) {
      p[k] = in.xyz[(size_t)i * 3 + k];
      ls[k] = in.scaling[(size_t)i * 3 + k];
      dc[k] = in.f_dc[(size_t)i * 3 + k];
    }
    const float4 q4 = in.rotation[i];
    q[0] = q4.x;
    q[1] = q4.y;
    q[2] = q4.z;
    q[3] = q4.w;
    op_logit = in.opacity[i];
    filt = in.filter_3d[i];
    read_cot(grad, grad_stride, i, g);
  }
  if constexpr (REST > 0) {
    const float* src = in.f_rest + (size_t)row0 * REST;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* sh4 = reinterpret_cast<float4*>(rest);
#pragma unroll 4
    for (int k = t; k < n4; k += NT) {
      if (act[(4 * k) / REST] || act[(4 * k + 3) / REST]) sh4[k] = __ldg(src4 + k);
    }
    for (int k = 4 * n4 + t; k < n; k += NT) {
      if (act[k / REST]) rest[k] = __ldg(src + k);
    }
    __syncthreads();
  }
  if (live) {
    RowGrad o;
    row_backward<D>(cam, p, ls, dc, rest + t * REST, q, op_logit, filt, n_sh, kernel_size,
                    scale_modifier, g, o);
    write_row(out, i, o);
  } else {
    if (i < P) write_zero_row(out, i);
    for (int k = 0; k < REST; ++k) rest[t * REST + k] = 0.f;
  }
  if constexpr (REST > 0) {  // the block's f_rest gradient, as 16-byte stores
    __syncthreads();
    const float4* sh4 = reinterpret_cast<const float4*>(rest);
    for (int k = t; k < n4; k += NT) dst4[k] = sh4[k];
    for (int k = 4 * n4 + t; k < n; k += NT) dst[k] = rest[k];
  }
}

template <int D>
int launch(const Inputs& in, const float* grad, long long grad_stride, const Grads& out, int P,
           int width, int height, int n_sh, float kernel_size, float scale_modifier,
           void* stream) {
  const int blocks = (P + NT - 1) / NT;
  preprocess_bwd_kernel<D><<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      in, grad, grad_stride, out, P, width, height, n_sh, kernel_size, scale_modifier);
  return static_cast<int>(cudaGetLastError());
}

constexpr int INVALID = static_cast<int>(cudaErrorInvalidValue);

#else  // the host build: the same rows, one after another

template <int D>
int launch(const Inputs& in, const float* grad, long long grad_stride, const Grads& out, int P,
           int width, int height, int n_sh, float kernel_size, float scale_modifier, void*) {
  constexpr int REST = ((D + 1) * (D + 1) - 1) * 3;
  const Cam cam = make_cam(in, width, height);
  float rest[REST > 0 ? REST : 1];
  for (int i = 0; i < P; ++i) {
    float* g_rest = out.f_rest + (size_t)i * REST;
    if (!in.active[i]) {
      write_zero_row(out, i);
      for (int k = 0; k < REST; ++k) g_rest[k] = 0.f;
      continue;
    }
    float p[3], ls[3], dc[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = in.xyz[(size_t)i * 3 + k];
      ls[k] = in.scaling[(size_t)i * 3 + k];
      dc[k] = in.f_dc[(size_t)i * 3 + k];
    }
    const float4 q4 = in.rotation[i];
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
    for (int k = 0; k < REST; ++k) rest[k] = in.f_rest[(size_t)i * REST + k];
    RowCot g;
    read_cot(grad, grad_stride, i, g);
    RowGrad o;
    row_backward<D>(cam, p, ls, dc, rest, q, in.opacity[i], in.filter_3d[i], n_sh, kernel_size,
                    scale_modifier, g, o);
    write_row(out, i, o);
    for (int k = 0; k < REST; ++k) g_rest[k] = rest[k];
  }
  return 0;
}

constexpr int INVALID = 1;

#endif

}  // namespace

// C entry, bound with ctypes by radegs_torch/ops/preprocess.py. The camera's R
// and T are read at their strides (in floats). `grad` is the table's incoming
// gradient, (P, N_FEAT) float32 with unit column stride and row stride
// `grad_stride` (in floats; the blend's backward hands over a view of its
// wider buffer), or null for none (zeros). `sh_degree` (0-3) is the state's
// maximum degree, the layout of f_rest; SH bands up to `active_sh_degree` are
// live. Launches on `stream` and returns cudaGetLastError() (0 on success);
// the host build runs the rows and returns 0.
extern "C" int radegs_preprocess_bwd(
    const void* xyz, const void* f_dc, const void* f_rest, const void* scaling,
    const void* rotation, const void* opacity, const void* filter_3d, const void* active,
    const void* R, const void* T, const void* fovx, const void* fovy, const void* grad,
    void* g_xyz, void* g_f_dc, void* g_f_rest, void* g_scaling, void* g_rotation,
    void* g_opacity, int grad_stride, int r_stride0, int r_stride1, int t_stride, int P,
    int width, int height, int sh_degree, int active_sh_degree, float kernel_size,
    float scale_modifier, void* stream) {
  if (sh_degree < 0 || sh_degree > 3 || active_sh_degree < 0 || P < 0 || grad_stride < 0) {
    return INVALID;
  }
  if (P == 0) return 0;
  const Inputs in{static_cast<const float*>(xyz),      static_cast<const float*>(f_dc),
                  static_cast<const float*>(f_rest),   static_cast<const float*>(scaling),
                  static_cast<const float4*>(rotation), static_cast<const float*>(opacity),
                  static_cast<const float*>(filter_3d), static_cast<const bool*>(active),
                  static_cast<const float*>(R),        static_cast<const float*>(T),
                  static_cast<const float*>(fovx),     static_cast<const float*>(fovy),
                  r_stride0,                           r_stride1,
                  t_stride};
  const auto* g = static_cast<const float*>(grad);
  const Grads out{static_cast<float*>(g_xyz),     static_cast<float*>(g_f_dc),
                  static_cast<float*>(g_f_rest),  static_cast<float*>(g_scaling),
                  static_cast<float4*>(g_rotation), static_cast<float*>(g_opacity)};
  const int n_sh = (active_sh_degree + 1) * (active_sh_degree + 1);
  switch (sh_degree) {
    case 0:
      return launch<0>(in, g, grad_stride, out, P, width, height, n_sh, kernel_size,
                       scale_modifier, stream);
    case 1:
      return launch<1>(in, g, grad_stride, out, P, width, height, n_sh, kernel_size,
                       scale_modifier, stream);
    case 2:
      return launch<2>(in, g, grad_stride, out, P, width, height, n_sh, kernel_size,
                       scale_modifier, stream);
    default:
      return launch<3>(in, g, grad_stride, out, P, width, height, n_sh, kernel_size,
                       scale_modifier, stream);
  }
}
