// K11: the tracker's live pyramid after K1. The reference has no kernel
// here (its pyramid is XLA array code, housescan_tpu/kinfu/preprocess.py
// build_pyramid); see housescan_tpu_torch/ops/pyramid_cuda.py for the
// plain version, whose ~450 small tensor operations a frame this replaces.
//
// Bound: bytes. At 640 x 480 and three levels it reads the filtered depth
// once (1.2 MB) and writes the two coarser depths and the three levels'
// (6, h, w) maps (10.1 MB): 0.0034 ms at 3.35 TB/s. Each pixel does ~60
// float operations, far under the float32 rate.
//
// Design. One launch a level, all on the caller's stream: launch l reads
// depth l, writes level l's maps (a thread a pixel) and, from a second
// range of the same grid, depth l + 1 (a thread a coarse pixel); the two
// ranges share no data, so the only dependency is launch to launch. A map
// thread recomputes its four neighbours' vertices from their depths (a
// vertex is a per-pixel function, so the bits are those of the plain
// version's vertex rows). Each value runs the plain version's float32
// operations in its order, as PyTorch runs them on the card:
//   * the downsample's taps dy outer, dx inner, each reading the
//     zero-filled depth[y - dy][x - dx]; the two running sums, one
//     division; only at the even pixels (2i, 2j) that halving keeps;
//   * a vertex ((x - cx) * (1 / fx)) * z: PyTorch divides a tensor by a
//     Python float as a multiply by its reciprocal, taken on the host in
//     double and rounded to float32; the other scalars and the gates are
//     the Python floats rounded to float32;
//   * the normal's neighbours wrap around (torch.roll), the cross product,
//     the norm, the division and the camera-facing flip as written there.
// Under --fmad=false and nvcc's correctly rounded division and square root
// the result is bit-identical to the plain version. CUDA C++ rather than
// Triton: the same route and build as K1, whose output it reads, and
// --fmad=false, which the bit-identity needs.
#include <math.h>

#include "common.cuh"

#define PY_THREADS 256
#define PY_MAX_LEVELS 16

struct PyCam {
  float cx, cy, inv_fx, inv_fy;
};

// The camera-frame vertex of pixel (x, y) of depth ``d`` (row stride w).
__device__ __forceinline__ float3 py_vertex(const float* __restrict__ d, int w, int x, int y,
                                            const PyCam& cam) {
  const float z = __ldg(&d[y * w + x]);
  return make_float3(((float)x - cam.cx) * cam.inv_fx * z, ((float)y - cam.cy) * cam.inv_fy * z,
                     z);
}

// Level maps of pixel p: rows 0-2 the vertex, rows 3-5 the normal.
__device__ __forceinline__ void py_maps(const float* __restrict__ d, float* __restrict__ maps,
                                        int h, int w, int p, const PyCam& cam, float jump) {
  const int y = p / w, x = p - y * w;
  const int xr = x + 1 == w ? 0 : x + 1, xl = x == 0 ? w - 1 : x - 1;
  const int yd = y + 1 == h ? 0 : y + 1, yu = y == 0 ? h - 1 : y - 1;
  const float3 v = py_vertex(d, w, x, y, cam);
  const float3 vr = py_vertex(d, w, xr, y, cam), vl = py_vertex(d, w, xl, y, cam);
  const float3 vd = py_vertex(d, w, x, yd, cam), vu = py_vertex(d, w, x, yu, cam);
  const float du0 = vr.x - vl.x, du1 = vr.y - vl.y, du2 = vr.z - vl.z;
  const float dv0 = vd.x - vu.x, dv1 = vd.y - vu.y, dv2 = vd.z - vu.z;
  const float nx = dv1 * du2 - dv2 * du1;
  const float ny = dv2 * du0 - dv0 * du2;
  const float nz = dv0 * du1 - dv1 * du0;
  const float norm = sqrtf(nx * nx + ny * ny + nz * nz);
  const float z = v.z;
  const bool continuous = fabsf(vr.z - z) < jump && fabsf(vl.z - z) < jump &&
                          fabsf(vd.z - z) < jump && fabsf(vu.z - z) < jump;
  const bool valid = z > 0.0f && vr.z > 0.0f && vl.z > 0.0f && vd.z > 0.0f && vu.z > 0.0f &&
                     continuous && norm > (float)1e-12;
  const float c = hs_clamp_min(norm, (float)1e-12);
  float n0 = nx / c, n1 = ny / c, n2 = nz / c;
  if (n0 * v.x + n1 * v.y + n2 * v.z > 0.0f) {
    n0 = -n0;
    n1 = -n1;
    n2 = -n2;
  }
  const int hw = h * w;
  maps[p] = v.x;
  maps[hw + p] = v.y;
  maps[2 * hw + p] = v.z;
  maps[3 * hw + p] = valid ? n0 : 0.0f;
  maps[4 * hw + p] = valid ? n1 : 0.0f;
  maps[5 * hw + p] = valid ? n2 : 0.0f;
}

// Coarse pixel q of the next level: the gated 3x3 smooth of fine pixel
// (2i, 2j), zero-filled outside the image.
__device__ __forceinline__ void py_down(const float* __restrict__ d, float* __restrict__ out,
                                        int h, int w, int q, float thr) {
  const int w2 = w >> 1;
  const int i = q / w2, j = q - i * w2;
  const int y = 2 * i, x = 2 * j;
  const float c = __ldg(&d[y * w + x]);
  float ws = 0.0f, vs = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int sy = y - dy, sx = x - dx;
      const float s = (sy >= 0 && sy < h && sx >= 0 && sx < w) ? __ldg(&d[sy * w + sx]) : 0.0f;
      const bool ok = s > 0.0f && fabsf(s - c) < thr;
      const float wv = ok ? (dy == 0 && dx == 0 ? 1.0f : 0.5f) : 0.0f;
      ws = ws + wv;
      vs = vs + wv * s;
    }
  }
  out[q] = (c > 0.0f && ws > 0.0f) ? vs / hs_clamp_min(ws, (float)1e-12) : 0.0f;
}

// Blocks [0, map_blocks): level maps from ``d``; the rest: the next depth.
__global__ void __launch_bounds__(PY_THREADS)
pyramid_level_kernel(const float* __restrict__ d, float* __restrict__ maps,
                     float* __restrict__ next, int h, int w, int map_blocks, PyCam cam,
                     float jump, float thr) {
  if ((int)blockIdx.x < map_blocks) {
    const int p = blockIdx.x * PY_THREADS + threadIdx.x;
    if (p < h * w) py_maps(d, maps, h, w, p, cam, jump);
  } else {
    const int q = (blockIdx.x - map_blocks) * PY_THREADS + threadIdx.x;
    if (q < (h >> 1) * (w >> 1)) py_down(d, next, h, w, q, thr);
  }
}

// depths[0] the filtered (h, w) depth, depths[1..levels-1] and maps[0..levels-1]
// the outputs ((h >> l, w >> l) and (6, h >> l, w >> l)); fx .. cy the
// level-0 intrinsics. ``levels`` launches on ``stream``; no synchronisation.
extern "C" int hs_pyramid(float* const* depths, float* const* maps, int levels, int h, int w,
                          double fx, double fy, double cx, double cy, double sigma_depth,
                          double max_depth_jump, void* stream) {
  if (levels < 1 || levels > PY_MAX_LEVELS || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  const float thr = (float)(3.0 * sigma_depth);
  const float jump = (float)max_depth_jump;
  for (int l = 0; l < levels; ++l) {
    const int hl = h >> l, wl = w >> l;
    // Intrinsics.level: the level's values in double; then PyTorch's
    // float32 scalars, and its reciprocals of a divisor: taken in double
    // from the Python float, then rounded (1.0f / (float)fx differs by an
    // ulp where fx is not a float, as 674.4 is not)
    const double f = (double)(1 << l);
    PyCam cam;
    cam.cx = (float)(cx / f);
    cam.cy = (float)(cy / f);
    cam.inv_fx = (float)(1.0 / (fx / f));
    cam.inv_fy = (float)(1.0 / (fy / f));
    const int n_maps = hl * wl;
    const int n_next = l + 1 < levels ? (hl >> 1) * (wl >> 1) : 0;
    const int map_blocks = (n_maps + PY_THREADS - 1) / PY_THREADS;
    const int blocks = map_blocks + (n_next + PY_THREADS - 1) / PY_THREADS;
    if (blocks == 0) continue;
    pyramid_level_kernel<<<blocks, PY_THREADS, 0, (cudaStream_t)stream>>>(
        depths[l], maps[l], l + 1 < levels ? depths[l + 1] : nullptr, hl, wl, map_blocks, cam,
        jump, thr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Resident blocks an SM: out[0] the level kernel.
extern "C" int hs_pyramid_occupancy(int, int* out) {
  return hs_occupancy(pyramid_level_kernel, PY_THREADS, 0, out);
}
