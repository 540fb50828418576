// Shared helpers of the housescan_tpu_torch kernels.
//
// The library builds with --fmad=false: every float multiply and add is
// rounded separately, as in the plain PyTorch versions, so the kernels
// repeat those versions' arithmetic operation for operation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HS_FULL_MASK 0xffffffffu

// Resident blocks an SM of ``kernel`` launched with ``threads`` threads and
// ``smem`` bytes of dynamic shared memory, by the occupancy calculator:
// what sizes the persistent grids and what chip_smoke.py reports.
template <class Kernel>
static int hs_occupancy(Kernel kernel, int threads, int smem, int* blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

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
// write the TSDF (K4, K5, K7, K8, K10). The math is float32 on every
// layout; a store only converts at load and store. ``load`` gives the
// float tsdf and weight of cell ``a`` (the flat (x, y, z) index),
// ``store`` writes them and returns the tsdf as stored, which is what a
// later read gives.
//   HsPacked: the packed (X, Y, Z) int32 grid;
//   HsPlanar<float>: the (2, X, Y, Z) float32 array, tsdf at data[0] and
//   weight at data[1], X * Y * Z cells further on (a 64-bit offset: at
//   1024^3, 2 X Y Z overflows an int);
//   HsPlanar<__nv_bfloat16>: the same array in bfloat16, read exactly as
//   float32 and stored rounded to nearest even (__float2bfloat16_rn, as
//   the plain version's .to(torch.bfloat16) and the reference's
//   astype(jnp.bfloat16)). Weights are small integers, exact in bf16.
// ``Cell`` is a store's element type.
//
// A chunk of 8 x 8 x 128 cells can also be staged in shared memory (K4):
// kPlanes planes of 64 z-rows, each row one bulk copy from ``plane_ptr``
// to a stride of HS_STAGE_ROW cells (128 and 8 of padding, so the plane
// fit's warps, which read 4 rows x 8 z at once, hit 32 distinct banks);
// the staged cell o = (ix * 8 + iy) * HS_STAGE_ROW + z is read with
// ``staged_load``, and ``store_staged`` writes a cell to the volume and
// to the staged copy alike. With 2-byte cells a row is 272 bytes (both
// the 256-byte copy and the stride multiples of 16, as a bulk copy
// needs), and the fit's 4 rows x 8 z fall on banks 4 apart: 16 distinct
// banks, two lanes a word, still no conflict.
enum { HS_LAYOUT_PACKED = 0, HS_LAYOUT_F32 = 1, HS_LAYOUT_BF16 = 2 };
#define HS_STAGE_ROW 136
#define HS_STAGE_PLANE (64 * HS_STAGE_ROW)

struct HsPacked {
  using Cell = int;
  static constexpr int kPlanes = 1;
  static constexpr int kCellBytes = 4;
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
  __device__ __forceinline__ const void* plane_ptr(size_t a, int) const { return v + a; }
  static __device__ __forceinline__ void staged_load(const void* s, int o, float& t, float& w) {
    const int c = static_cast<const int*>(s)[o];
    t = hs_unpack_t(c);
    w = hs_unpack_w(c);
  }
  __device__ __forceinline__ float store_staged(void* s, int o, size_t a, float t,
                                                float w) const {
    const int c = hs_pack(t, w);
    v[a] = c;
    static_cast<int*>(s)[o] = c;
    return hs_unpack_t(c);
  }
};

__device__ __forceinline__ float hs_to_f32(float x) { return x; }
__device__ __forceinline__ float hs_to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T hs_from_f32(float x);
template <>
__device__ __forceinline__ float hs_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 hs_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct HsPlanar {
  using Cell = T;
  static constexpr int kPlanes = 2;
  static constexpr int kCellBytes = (int)sizeof(T);
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
  __device__ __forceinline__ const void* plane_ptr(size_t a, int pl) const {
    return v + pl * plane + a;
  }
  static __device__ __forceinline__ void staged_load(const void* s, int o, float& t, float& w) {
    t = hs_to_f32(static_cast<const T*>(s)[o]);
    w = hs_to_f32(static_cast<const T*>(s)[HS_STAGE_PLANE + o]);
  }
  __device__ __forceinline__ float store_staged(void* s, int o, size_t a, float t,
                                                float w) const {
    const T ts = hs_from_f32<T>(t), ws = hs_from_f32<T>(w);
    v[a] = ts;
    v[plane + a] = ws;
    static_cast<T*>(s)[o] = ts;
    static_cast<T*>(s)[HS_STAGE_PLANE + o] = ws;
    return hs_to_f32(ts);
  }
};

// Hopper's asynchronous bulk copy into shared memory, completing on an
// mbarrier (PTX; sm_90). ``hs_mbar_*`` take the barrier's shared address.
__device__ __forceinline__ uint32_t hs_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void hs_mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(hs_smem_addr(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Arrive on ``bar`` and expect ``bytes`` more of copies in this phase.
__device__ __forceinline__ void hs_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(hs_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void hs_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(hs_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Order this thread's earlier shared-memory accesses before later
// asynchronous copies into shared memory.
__device__ __forceinline__ void hs_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Copy ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completion is counted on ``bar``.
__device__ __forceinline__ void hs_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(hs_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hs_smem_addr(bar))
      : "memory");
}

// The terms that world axis ``a`` (0 x, 1 y, 2 z) adds to a voxel's
// camera-space (xc, yc, zc), for the voxel at index base + i along that
// axis (base: the chunk's first voxel), under the params vector of
// ops/tsdf_stream._stream_params: d r[0][a], d r[1][a], d r[2][a], with d
// the voxel centre's world coordinate less the camera's.
struct HsAxisTerms {
  float c0, c1, c2;
};
__device__ __forceinline__ HsAxisTerms hs_voxel_axis(const float* p, int a, int base, int i) {
  const float d = (p[18 + a] + ((float)base + (float)i + 0.5f) * p[17]) - p[9 + a];
  return {d * p[a], d * p[3 + a], d * p[6 + a]};
}

// Camera-space (xc, yc, zc) of voxel (ix, iy, z) of chunk (ci, cj, ck): the
// three axes' terms added x, y, z in that order (K4 hoists each axis's
// terms out of its voxel loop and adds them in the same order).
__device__ __forceinline__ void hs_voxel_cam(const float* p, int ci, int cj, int ck, int ix,
                                             int iy, int z, float& xc, float& yc, float& zc) {
  const HsAxisTerms ax = hs_voxel_axis(p, 0, ci * 8, ix), ay = hs_voxel_axis(p, 1, cj * 8, iy);
  const HsAxisTerms az = hs_voxel_axis(p, 2, ck * 128, z);
  xc = ax.c0 + ay.c0 + az.c0;
  yc = ax.c1 + ay.c1 + az.c1;
  zc = ax.c2 + ay.c2 + az.c2;
}

// The reference's CLS_FREE in-view test, multiplied through by zc (no
// division).
__device__ __forceinline__ bool hs_in_view_free(const float* p, float xc, float yc, float zc) {
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float img_w = p[22], img_h = p[23];
  const float fxx = fx * xc, fyy = fy * yc;
  return (zc > 1e-6f) && (fxx >= -cx * zc) && (fxx <= (img_w - 1.0f - cx) * zc) &&
         (fyy >= -cy * zc) && (fyy <= (img_h - 1.0f - cy) * zc);
}

// Camera-space depth zc, pixel (uf, vf) and the two in-view tests of voxel
// (ix, iy, z) of chunk (ci, cj, ck): iv is the plain test, iv_free the one
// multiplied through by zc.
struct HsVoxel {
  float zc, uf, vf, iv_free, iv;
};

// The same from the voxel's camera-space position.
__device__ __forceinline__ void hs_voxel_project(const float* p, float xc, float yc, float zc,
                                                 HsVoxel& o) {
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float img_w = p[22], img_h = p[23];
  o.zc = zc;
  o.iv_free = hs_in_view_free(p, xc, yc, zc) ? 1.0f : 0.0f;
  const float safe_z = hs_clamp_min(zc, 1e-6f);
  o.uf = fx * xc / safe_z + cx;
  o.vf = fy * yc / safe_z + cy;
  o.iv = ((zc > 1e-6f) && (o.uf >= 0.0f) && (o.uf <= img_w - 1.0f) && (o.vf >= 0.0f) &&
          (o.vf <= img_h - 1.0f))
             ? 1.0f
             : 0.0f;
}

__device__ __forceinline__ void hs_voxel_coords(const float* p, int ci, int cj, int ck, int ix,
                                                int iy, int z, HsVoxel& o) {
  float xc, yc, zc;
  hs_voxel_cam(p, ci, cj, ck, ix, iy, z, xc, yc, zc);
  hs_voxel_project(p, xc, yc, zc, o);
}
