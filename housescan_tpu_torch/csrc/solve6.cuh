// Damped 6x6 solve + twist exponential + pose compose: the math of
// housescan_tpu/ops/solve6_pallas.py (_solve_twist_math, K2's body) as
// device functions that K3 (icp.cu: hs_solve_twist, serial) and K2
// (solve6.cu: one warp) build on. Operation for operation the plain version
// housescan_tpu_torch/ops/solve6.py; the pieces take the two choices that
// differ between the kernels as parameters (how a solve divides by a
// diagonal entry of L, and how the sine's last Taylor term divides), so
// each kernel's arithmetic is fixed by its call.
#pragma once

#include "common.cuh"

// kRecip: the last term multiplies by the float reciprocal of 362880, as
// PyTorch's CUDA division of a tensor by a Python scalar does (K2's plain
// version runs on the card); else it divides (K3, as before).
template <bool kRecip>
__device__ __forceinline__ float hs_sin_taylor(float t) {
  const float t2 = t * t;
  const float last = kRecip ? t2 * (1.0f / 362880.0f) : t2 / 362880.0f;
  return t * (1.0f + t2 * ((float)(-1.0 / 6) +
                           t2 * ((float)(1.0 / 120) + t2 * ((float)(-1.0 / 5040) + last))));
}

__device__ __forceinline__ float hs_cos_taylor(float t) {
  const float t2 = t * t;
  return 1.0f + t2 * (-0.5f + t2 * ((float)(1.0 / 24) +
                                    t2 * ((float)(-1.0 / 720) + t2 * (float)(1.0 / 40320))));
}

// lam = max(damping, null threshold) * max(A00, |A11|, ..., |A55|) (at
// least 1e-12).
__device__ __forceinline__ float hs_solve_lambda(const float* a, float damping) {
  const float null_threshold = 1e-2f;
  float scale = a[0];
  for (int i = 1; i < 6; ++i) scale = fmaxf(scale, fabsf(a[i * 6 + i]));
  scale = hs_clamp_min(scale, 1e-12f);
  return hs_clamp_min(damping, null_threshold) * scale;
}

// The lower Cholesky factor L of A + lam I, row by row; returns whether
// every pivot was > 0.
__device__ __forceinline__ bool hs_cholesky6(const float* a, float lam, float (*L)[6]) {
  bool ok = true;
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = (i == j) ? a[i * 6 + j] + lam : a[i * 6 + j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        ok = ok && (s > 0.0f);
        L[i][j] = sqrtf(hs_clamp_min(s, 1e-30f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  }
  return ok;
}

// x = (L L^T)^-1 rhs: forward then back substitution, each row's sum in
// ascending k, then div(s, L[i][i], i) = s / L[i][i].
template <class Div>
__device__ __forceinline__ void hs_chol_solve6(float (*L)[6], const float* rhs, float* x,
                                               const Div& div) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = div(s, L[i][i], i);
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = div(s, L[i][i], i);
  }
}

// out = A v, each row summed k = 0..5 in order.
__device__ __forceinline__ void hs_matvec6(const float* a, const float* v, float* out) {
  for (int i = 0; i < 6; ++i) {
    float s = a[i * 6] * v[0];
    for (int k = 1; k < 6; ++k) s = s + a[i * 6 + k] * v[k];
    out[i] = s;
  }
}

// From the filtered step x (6) and the solve's ok: the non-finite and >1e3
// guards, the max-step clamp, Rodrigues, then pose @ increment into
// out[0..15] (the pose kept where the solve failed) and the post-clamp
// step norm into out[16] (0 then).
template <bool kRecip>
__device__ __forceinline__ void hs_twist_compose(float* x, bool ok, const float* pose,
                                                 float max_step, float* out) {
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
  for (int i = 0; i < 6; ++i) x[i] = ok ? x[i] : 0.0f;
  float nrm2 = x[0] * x[0];
  for (int i = 1; i < 6; ++i) nrm2 = nrm2 + x[i] * x[i];
  float nrm = sqrtf(hs_clamp_min(nrm2, 1e-24f));
  ok = ok && (nrm <= 1e3f);
  for (int i = 0; i < 6; ++i) x[i] = ok ? x[i] : 0.0f;
  nrm = ok ? nrm : 0.0f;
  const float fac = nrm > max_step ? max_step / nrm : 1.0f;
  for (int i = 0; i < 6; ++i) x[i] = x[i] * fac;

  const float wx = x[0], wy = x[1], wz = x[2];
  const float theta = sqrtf(hs_clamp_min(wx * wx + wy * wy + wz * wz, 0.0f));
  const float safe_t = hs_clamp_min(theta, 1e-12f);
  const bool small = theta <= 1e-12f;
  const float kx = small ? 0.0f : wx / safe_t;
  const float ky = small ? 0.0f : wy / safe_t;
  const float kz = small ? 0.0f : wz / safe_t;
  const float s = hs_sin_taylor<kRecip>(theta);
  const float c = hs_cos_taylor(theta);
  const float one_c = 1.0f - c;

  const float r00 = c + one_c * kx * kx;
  const float r01 = s * (-kz) + one_c * kx * ky;
  const float r02 = s * ky + one_c * kx * kz;
  const float r10 = s * kz + one_c * ky * kx;
  const float r11 = c + one_c * ky * ky;
  const float r12 = s * (-kx) + one_c * ky * kz;
  const float r20 = s * (-ky) + one_c * kz * kx;
  const float r21 = s * kx + one_c * kz * ky;
  const float r22 = c + one_c * kz * kz;
  const float inc[4][4] = {
      {r00, r10, r20, 0.0f},
      {r01, r11, r21, 0.0f},
      {r02, r12, r22, 0.0f},
      {x[3], x[4], x[5], 1.0f},
  };
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      float acc = pose[i * 4] * inc[0][j];
      for (int k = 1; k < 4; ++k) acc = acc + pose[i * 4 + k] * inc[k][j];
      out[i * 4 + j] = ok ? acc : pose[i * 4 + j];
    }
  }
  out[16] = ok ? nrm * fac : 0.0f;
}

// A solve's division by L[i][i] as the operator itself.
struct HsDivPlain {
  __device__ __forceinline__ float operator()(float s, float d, int) const { return s / d; }
};

// a: 36 (row-major A), b: 6, pose: 16 (row-major, row-vector convention).
// out: 16 new pose entries + the post-clamp step norm (0 when the solve
// failed and the pose was kept). Serial, as K3 inlines it.
__device__ inline void hs_solve_twist(const float* a, const float* b, const float* pose,
                                      float damping, float max_step, float* out) {
  float L[6][6];
  const bool ok = hs_cholesky6(a, hs_solve_lambda(a, damping), L);
  float z[6], az[6], x[6];
  // z = (A + lam I)^-1 b, then x = (A + lam I)^-1 A z
  hs_chol_solve6(L, b, z, HsDivPlain{});
  hs_matvec6(a, z, az);
  hs_chol_solve6(L, az, x, HsDivPlain{});
  hs_twist_compose<false>(x, ok, pose, max_step, out);
}
