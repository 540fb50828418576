// Shared helpers of the housescan_tpu_torch kernels.
//
// The library builds with --fmad=false: every float multiply and add is
// rounded separately, as in the plain PyTorch versions, so the kernels
// repeat those versions' arithmetic operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HS_FULL_MASK 0xffffffffu

// max(x, lo) / min(x, hi) that keep a NaN x, as torch.clamp does.
__device__ __forceinline__ float hs_clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float hs_clamp_max(float x, float hi) { return x > hi ? hi : x; }

// min / max over a warp (exact in any order).
__device__ __forceinline__ float hs_warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(HS_FULL_MASK, v, o));
  return v;
}
__device__ __forceinline__ float hs_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(HS_FULL_MASK, v, o));
  return v;
}

// Packed volume cell: tsdf quantized to [-32767, 32767] in the high half,
// integer weight in the low half (housescan_tpu_torch/kinfu/tsdf.py).
__device__ __forceinline__ float hs_unpack_t(int v) {
  return (float)(v >> 16) * (float)(1.0 / 32767.0);
}
__device__ __forceinline__ float hs_unpack_w(int v) { return (float)(v & 0xFFFF); }
__device__ __forceinline__ int hs_pack(float t, float w) {
  float tc = hs_clamp_max(hs_clamp_min(t, -1.0f), 1.0f);
  int ti = (int)rintf(tc * 32767.0f);  // rintf rounds half to even, as torch.round
  return (int)(((unsigned)ti << 16) | (unsigned)(int)w);
}

// Volume storage: the template parameter of the kernels that read and
// write the TSDF (K4, K5, K7, K8). The math is float32 on every layout;
// a store only converts at load and store. ``load`` gives the float tsdf
// and weight of cell ``a`` (the flat (x, y, z) index), ``store`` writes
// them and returns the tsdf as stored, which is what a later read gives.
//   HsPacked: the packed (X, Y, Z) int32 grid;
//   HsPlanar<float>: the (2, X, Y, Z) float32 array, tsdf at data[0] and
//   weight at data[1], X * Y * Z cells further on (a 64-bit offset: at
//   1024^3, 2 X Y Z overflows an int). A bfloat16 volume is
//   HsPlanar<__nv_bfloat16> with its two conversions (not ported).
enum { HS_LAYOUT_PACKED = 0, HS_LAYOUT_F32 = 1, HS_LAYOUT_BF16 = 2 };

struct HsPacked {
  int* v;
  __device__ __forceinline__ void load(size_t a, float& t, float& w) const {
    const int c = v[a];
    t = hs_unpack_t(c);
    w = hs_unpack_w(c);
  }
  __device__ __forceinline__ float store(size_t a, float t, float w) const {
    const int c = hs_pack(t, w);
    v[a] = c;
    return hs_unpack_t(c);
  }
};

__device__ __forceinline__ float hs_to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T hs_from_f32(float x);
template <>
__device__ __forceinline__ float hs_from_f32<float>(float x) { return x; }

template <typename T>
struct HsPlanar {
  T* v;
  size_t plane;  // X * Y * Z
  __device__ __forceinline__ void load(size_t a, float& t, float& w) const {
    t = hs_to_f32(v[a]);
    w = hs_to_f32(v[plane + a]);
  }
  __device__ __forceinline__ float store(size_t a, float t, float w) const {
    const T ts = hs_from_f32<T>(t);
    v[a] = ts;
    v[plane + a] = hs_from_f32<T>(w);
    return hs_to_f32(ts);
  }
};

// Camera-space depth zc, pixel (uf, vf) and the two in-view tests of voxel
// (ix, iy, z) of chunk (ci, cj, ck) under the params vector of
// ops/tsdf_stream._stream_params: iv is the plain test, iv_free the one
// multiplied through by zc (the reference's CLS_FREE form).
struct HsVoxel {
  float zc, uf, vf, iv_free, iv;
};

__device__ __forceinline__ void hs_voxel_coords(const float* p, int ci, int cj, int ck, int ix,
                                                int iy, int z, HsVoxel& o) {
  const float r00 = p[0], r01 = p[1], r02 = p[2], r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float tx = p[9], ty = p[10], tz = p[11];
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float vs = p[17], ox = p[18], oy = p[19], oz = p[20];
  const float img_w = p[22], img_h = p[23];
  const float xw = ox + ((float)(ci * 8) + (float)ix + 0.5f) * vs;
  const float yw = oy + ((float)(cj * 8) + (float)iy + 0.5f) * vs;
  const float zw = oz + ((float)(ck * 128) + (float)z + 0.5f) * vs;
  const float dx = xw - tx, dy = yw - ty, dz = zw - tz;
  const float xc = dx * r00 + dy * r01 + dz * r02;
  const float yc = dx * r10 + dy * r11 + dz * r12;
  const float zc = dx * r20 + dy * r21 + dz * r22;
  const float fxx = fx * xc, fyy = fy * yc;
  o.zc = zc;
  o.iv_free = ((zc > 1e-6f) && (fxx >= -cx * zc) && (fxx <= (img_w - 1.0f - cx) * zc) &&
               (fyy >= -cy * zc) && (fyy <= (img_h - 1.0f - cy) * zc))
                  ? 1.0f
                  : 0.0f;
  const float safe_z = hs_clamp_min(zc, 1e-6f);
  o.uf = fx * xc / safe_z + cx;
  o.vf = fy * yc / safe_z + cy;
  o.iv = ((zc > 1e-6f) && (o.uf >= 0.0f) && (o.uf <= img_w - 1.0f) && (o.vf >= 0.0f) &&
          (o.vf <= img_h - 1.0f))
             ? 1.0f
             : 0.0f;
}
