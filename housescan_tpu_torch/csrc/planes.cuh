// Per-sub-block surface-plane fit: the math of housescan_tpu/ops/
// planes_pallas.py plane_fields_for_block (line 76), shared by K4
// (tsdf_stream.cu, the refit of listed chunks), K7 (planes_extract.cu,
// every chunk) and K8 (tsdf_dense.cu, whole columns). Operation for
// operation the plain version housescan_tpu_torch/ops/planes.py: float32
// moment terms summed in double and rounded once, then the eigen analysis
// in float32.
//
// A fit reads its voxels through an accessor tw(ix, iy, z, t, w); the
// chunk kernels keep the chunk in shared memory, as floats (HsSmemChunk,
// K7's float32 planes; K8's own accessor reads the +z halo from the next
// chunk's buffer, where the crossings run on along its columns) or in the
// volume's own cells (HsStagedChunk, K4 and K7's packed one). Where the sub-blocks lie and what they are
// called come in as HsFitGeom, so one fit serves chunk ids (K4, K7) and
// column ids (K8). The eigen analysis splits into the shape (from the
// moments alone) and the fields (where the sub-block lies), so K8 computes
// the shape of an unobserved sub-block once.
#pragma once

#include "common.cuh"

#define HS_N_FIELDS 16
#define HS_NSUB 16
#define HS_NMOM 19

// A chunk's tsdf and weight planes in shared memory as float32 or
// bfloat16 cells, t[(ix * 8 + iy) * zs + z] (zs: a staged z-row's
// stride), read as floats.
template <typename T>
struct HsSmemChunk {
  const T* t;
  const T* w;
  int zs;
  __device__ __forceinline__ void operator()(int ix, int iy, int z, float& tv, float& wv) const {
    const int o = (ix * 8 + iy) * zs + z;
    tv = hs_to_f32(t[o]);
    wv = hs_to_f32(w[o]);
  }
};

// A chunk staged in shared memory in its volume's own cells (K4): read as
// Store::staged_load unpacks them, which is what ``store`` returned.
template <class Store>
struct HsStagedChunk {
  const void* s;
  __device__ __forceinline__ void operator()(int ix, int iy, int z, float& tv, float& wv) const {
    Store::staged_load(s, (ix * 8 + iy) * HS_STAGE_ROW + z, tv, wv);
  }
};

// Where a chunk's sub-blocks lie: sub-block s has id sid_base + sub and its
// first voxel at z = z_base + 8 sub (sub = s for a chunk, the column's
// sub-block index for K8).
struct HsFitGeom {
  int ci, cj;
  float z_base;
  long long sid_base;
  float vs, ox, oy, oz, min_count;
};

__device__ __forceinline__ float hs_wt(float wa, float wb) {
  return hs_clamp_max(fminf(wa, wb), 8.0f) * 0.125f;
}

__device__ __forceinline__ float hs_alpha(float t0, float t1) {
  const float denom = t0 - t1;
  const bool ok = fabsf(denom) > 1e-12f;
  const float a = ok ? t0 / denom : 0.5f;
  return hs_clamp_max(hs_clamp_min(a, 0.0f), 1.0f);
}

// Moment terms of the crossing from a voxel (tsdf tv, weight wv) to its
// neighbour (tn, wn) along one axis, at (px, py, pz) plus the crossing's
// fraction along that axis (``axis`` 0, 1, 2 = x, y, z), added into
// acc[0..10]. Without a crossing every term is a zero, which adds nothing
// to the exact double sums: skipped, so most voxels do no double work and
// no division.
__device__ __forceinline__ void hs_crossing_terms(double* acc, bool crossing, float tv, float tn,
                                                  float wv, float wn, float px, float py,
                                                  float pz, int axis) {
  if (!crossing) return;
  const float a = hs_alpha(tv, tn);
  if (axis == 0) px = px + a;
  if (axis == 1) py = py + a;
  if (axis == 2) pz = pz + a;
  const float m = hs_wt(wv, wn);  // the crossing flag (1) times its weight
  acc[0] += (double)m;
  acc[1] += (double)(m * px);
  acc[2] += (double)(m * py);
  acc[3] += (double)(m * pz);
  acc[4] += (double)(m * px * px);
  acc[5] += (double)(m * py * py);
  acc[6] += (double)(m * pz * pz);
  acc[7] += (double)(m * px * py);
  acc[8] += (double)(m * px * pz);
  acc[9] += (double)(m * py * pz);
  acc[10] += 1.0;
}

// Moments of voxel (ix, iy, z); the +z crossing counts only for z < z_lim
// (the +x and +y ones stay inside the 8 x 8 column). Every term needs the
// voxel observed (weight > 0): an unobserved voxel reads no neighbour and
// adds nothing. Returns whether it was observed.
template <class Tw>
__device__ __forceinline__ bool hs_voxel_moments(double* acc, const Tw& tw, int ix, int iy, int z,
                                                 int z_lim) {
  float tv, wv;
  tw(ix, iy, z, tv, wv);
  if (!(wv > 0.0f)) return false;
  const float x = (float)ix, yf = (float)iy;
  const float zz = (float)(z & 7);
  {  // +z neighbour
    float tn, wn;
    tw(ix, iy, z < z_lim ? z + 1 : z, tn, wn);
    hs_crossing_terms(acc, wn > 0.0f && ((tv < 0.0f) != (tn < 0.0f)) && z < z_lim, tv, tn, wv,
                      wn, x, yf, zz, 2);
  }
  {  // +y neighbour
    float tn, wn;
    tw(ix, iy < 7 ? iy + 1 : iy, z, tn, wn);
    hs_crossing_terms(acc, wn > 0.0f && ((tv < 0.0f) != (tn < 0.0f)) && iy < 7, tv, tn, wv, wn,
                      x, yf, zz, 1);
  }
  {  // +x neighbour
    float tn, wn;
    tw(ix < 7 ? ix + 1 : ix, iy, z, tn, wn);
    hs_crossing_terms(acc, wn > 0.0f && ((tv < 0.0f) != (tn < 0.0f)) && ix < 7, tv, tn, wv, wn,
                      x, yf, zz, 0);
  }
  // the band terms (the band flag times each; off the band zeros, skipped)
  if (!(fabsf(tv) < 0.99f)) return true;
  acc[11] += 1.0;
  acc[12] += (double)tv;
  acc[13] += (double)x;
  acc[14] += (double)yf;
  acc[15] += (double)zz;
  acc[16] += (double)(x * tv);
  acc[17] += (double)(yf * tv);
  acc[18] += (double)(zz * tv);
  return true;
}

struct HsInv3 {
  float rxx, ryy, rzz, cxy, cxz, cyz, det;
};

__device__ __forceinline__ float hs_inv_iter(const HsInv3& c, float& bx, float& by, float& bz) {
  const float ux = (bx * (c.ryy * c.rzz - c.cyz * c.cyz) - c.cxy * (by * c.rzz - c.cyz * bz) +
                    c.cxz * (by * c.cyz - c.ryy * bz)) / c.det;
  const float uy = (c.rxx * (by * c.rzz - bz * c.cyz) - bx * (c.cxy * c.rzz - c.cyz * c.cxz) +
                    c.cxz * (c.cxy * bz - by * c.cxz)) / c.det;
  const float uz = (c.rxx * (c.ryy * bz - by * c.cyz) - c.cxy * (c.cxy * bz - by * c.cxz) +
                    bx * (c.cxy * c.cyz - c.ryy * c.cxz)) / c.det;
  const float norm = sqrtf(ux * ux + uy * uy + uz * uz);
  const float safe_n = hs_clamp_min(norm, 1e-20f);
  bx = ux / safe_n;
  by = uy / safe_n;
  bz = uz / safe_n;
  return norm;
}

// What a sub-block's 19 float moments give before its place in the volume
// enters: the signed unit normal, the centroid in the sub-block, the count,
// the smallest eigenvalue, the in-plane radius and the shape tests.
struct HsPlaneShape {
  float nx, ny, nz, mx, my, mz, cnt, lam_min, r_inplane;
  bool ok;  // ok_plane && ok_spread
};

static __device__ HsPlaneShape hs_plane_shape(const float* acc) {
  const float ridge = 1e-4f;
  HsPlaneShape o;
  o.cnt = acc[10];
  const float n0 = hs_clamp_min(acc[0], 1e-6f);
  const float mx = acc[1] / n0, my = acc[2] / n0, mz = acc[3] / n0;
  const float cxx = hs_clamp_min(acc[4] / n0 - mx * mx, 0.0f);
  const float cyy = hs_clamp_min(acc[5] / n0 - my * my, 0.0f);
  const float czz = hs_clamp_min(acc[6] / n0 - mz * mz, 0.0f);
  const float cxy = acc[7] / n0 - mx * my;
  const float cxz = acc[8] / n0 - mx * mz;
  const float cyz = acc[9] / n0 - my * mz;

  HsInv3 c;
  c.rxx = cxx + ridge;
  c.ryy = cyy + ridge;
  c.rzz = czz + ridge;
  c.cxy = cxy;
  c.cxz = cxz;
  c.cyz = cyz;
  const float det = c.rxx * (c.ryy * c.rzz - cyz * cyz) - cxy * (cxy * c.rzz - cyz * cxz) +
                    cxz * (cxy * cyz - c.ryy * cxz);
  c.det = fabsf(det) > 1e-18f ? det : 1.0f;

  const float seed_x = (cxx <= cyy && cxx <= czz) ? 1.0f : 0.0f;
  const float seed_z = (czz < cxx && czz < cyy) ? 1.0f : 0.0f;
  float nx = seed_x, ny = 1.0f - seed_x - seed_z, nz = seed_z;
  hs_inv_iter(c, nx, ny, nz);
  hs_inv_iter(c, nx, ny, nz);
  const float growth = hs_inv_iter(c, nx, ny, nz);
  const float lam_min = hs_clamp_min(1.0f / hs_clamp_min(growth, 1e-6f) - ridge, 0.0f);
  const bool ok_plane = lam_min < 0.3f;

  const float trace = cxx + cyy + czz;
  const float px_ = (cxx >= cyy && cxx >= czz) ? 1.0f : 0.0f;
  const float pz_ = (czz > cxx && czz > cyy) ? 1.0f : 0.0f;
  const float py_ = 1.0f - px_ - pz_;
  float ux = cxx * px_ + cxy * py_ + cxz * pz_;
  float uy = cxy * px_ + cyy * py_ + cyz * pz_;
  float uz = cxz * px_ + cyz * py_ + czz * pz_;
  const float un = hs_clamp_min(sqrtf(ux * ux + uy * uy + uz * uz), 1e-20f);
  ux = ux / un;
  uy = uy / un;
  uz = uz / un;
  const float lam_max = ux * (cxx * ux + cxy * uy + cxz * uz) +
                        uy * (cxy * ux + cyy * uy + cyz * uz) +
                        uz * (cxz * ux + cyz * uy + czz * uz);
  const float lam_mid = hs_clamp_min(trace - lam_max - lam_min, 0.0f);
  const bool ok_spread = lam_mid > 0.1f;

  const float g0 = hs_clamp_min(acc[11], 1.0f);
  const float gs = acc[12] / g0;
  const float gmx = acc[13] / g0, gmy = acc[14] / g0, gmz = acc[15] / g0;
  const float gx_o = acc[16] / g0 - gmx * gs;
  const float gy_o = acc[17] / g0 - gmy * gs;
  const float gz_o = acc[18] / g0 - gmz * gs;
  const float sign = (nx * gx_o + ny * gy_o + nz * gz_o < 0.0f) ? -1.0f : 1.0f;
  o.nx = nx * sign;
  o.ny = ny * sign;
  o.nz = nz * sign;
  o.mx = mx;
  o.my = my;
  o.mz = mz;
  o.lam_min = lam_min;
  o.r_inplane = 1.8f * sqrtf(hs_clamp_min(trace - lam_min, 0.0f));
  o.ok = ok_plane && ok_spread;
  return o;
}

// The 16 fields of sub-block ``sub`` of a chunk from its shape.
__device__ __forceinline__ void hs_plane_emit(const HsPlaneShape& sh, const HsFitGeom& g,
                                              float sub, float* out) {
  const float wx = g.ox + ((float)(g.ci * 8) + sh.mx + 0.5f) * g.vs;
  const float wy = g.oy + ((float)(g.cj * 8) + sh.my + 0.5f) * g.vs;
  const float wz = g.oz + (g.z_base + sub * 8.0f + sh.mz + 0.5f) * g.vs;
  const float d = sh.nx * wx + sh.ny * wy + sh.nz * wz;

  const bool valid = (sh.cnt >= g.min_count) && sh.ok;
  const float vf = valid ? 1.0f : 0.0f;
  out[0] = sh.nx * vf;
  out[1] = sh.ny * vf;
  out[2] = sh.nz * vf;
  out[3] = d * vf;
  out[4] = vf;
  out[5] = sh.cnt;
  out[6] = (float)g.sid_base + sub;
  out[7] = (sh.r_inplane + 1.5f) * g.vs;
  out[8] = wx;
  out[9] = wy;
  out[10] = wz;
  out[11] = 0.0f;
  out[12] = sh.lam_min;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 0.0f;
}

// Fields of sub-block ``sub`` of a chunk from its 19 float moments.
__device__ __forceinline__ void hs_plane_fields(const float* acc, const HsFitGeom& g, float sub,
                                                float* out) {
  hs_plane_emit(hs_plane_shape(acc), g, sub, out);
}

// Warp moments of sub-block s (z in [8 s, 8 s + 8) of the chunk): lane l
// takes z = 8 s + l % 8 and rows iy = l / 8 + 4 k of every ix; the
// moments are summed in double over the warp into lane 0's acc. A warp
// with no observed voxel has only zero terms: its sums stay 0 without the
// shuffles (exact).
template <class Tw>
__device__ __forceinline__ void hs_subblock_moments_warp(const Tw& tw, int s, int lane, int z_lim,
                                                         double* acc) {
#pragma unroll
  for (int k = 0; k < HS_NMOM; ++k) acc[k] = 0.0;
  const int zv = s * 8 + (lane & 7);
  bool obs = false;
  for (int ix = 0; ix < 8; ++ix)
    for (int iy = lane >> 3; iy < 8; iy += 4) obs |= hs_voxel_moments(acc, tw, ix, iy, zv, z_lim);
  if (!__any_sync(HS_FULL_MASK, obs)) return;
#pragma unroll
  for (int k = 0; k < HS_NMOM; ++k)
    for (int o = 16; o > 0; o >>= 1) acc[k] += __shfl_down_sync(HS_FULL_MASK, acc[k], o);
}

// Warp fit of sub-block s: its moments, then lane 0 writes every field but
// 11 into fields[k][s] (shared memory, (HS_N_FIELDS, HS_NSUB)).
template <class Tw>
__device__ __forceinline__ void hs_fit_subblock_warp(const Tw& tw, int s, int lane, int z_lim,
                                                     const HsFitGeom& g, float sub,
                                                     float (*fields)[HS_NSUB]) {
  double acc[HS_NMOM];
  hs_subblock_moments_warp(tw, s, lane, z_lim, acc);
  if (lane == 0) {
    float accf[HS_NMOM], f[HS_N_FIELDS];
    for (int k = 0; k < HS_NMOM; ++k) accf[k] = (float)acc[k];
    hs_plane_fields(accf, g, sub, f);
    for (int k = 0; k < HS_N_FIELDS; ++k)
      if (k != 11) fields[k][s] = f[k];
  }
}
