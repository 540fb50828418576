// K10: the zero-isosurface mesh of the scan's export (marching tetrahedra),
// one call of three kernels. It replaces no Pallas kernel: the JAX package
// computes the mesh as XLA array code (housescan_tpu/kinfu/marching_cubes.py,
// slab by slab in _slab_count and _slab_compact), as it does the prepass
// that K9 took over. The port's plain version
// (housescan_tpu_torch/kinfu/marching_cubes.py marching_cubes_plain) sweeps
// the volume in X-slabs, about 1,100 small tensor operations and one host
// wait a slab: 64 slabs and about 70,000 operations at 1024^3, at ~21 us of
// host dispatch each. These kernels give the same triangle soup in the same
// order, bit for bit, and the host waits for the triangle count, then for
// the triangles' copy.
//
// Bound: the volume read once (tsdf and weight: 8 bytes a cell float32, 4
// bfloat16 and packed) and the triangles written once (36 bytes each):
// 8.59 GB and 85.6 MB at 1024^3 float32, 2.59 ms at 3.35 TB/s. The
// tetrahedra's arithmetic runs on the active cells only (about 0.1%).
//
// Order. Triangles are ordered by X-slab (cell x belongs to slab x / slab:
// the plain version's last slab is clamped to the volume but owns its cells
// from i * slab on, which is the same), then by slot (tet * 2 + k, 12
// slots), then by cell raster order (x, y, z) within the slab. A unit is
// one x and MT_ROWS consecutive y rows of cells, every z: a run of
// consecutive raster cells within one slab, so the units' counts, scanned
// within each (slab, slot) and then over (slab, slot), give every unit its
// base for each slot.
//
//  1. mt_classify_kernel: a block a unit, a warp a 32-cell word of a row
//     (a thread a cell, threads along z). A thread reads its cell's 8
//     corners through the storage template; the cell is active when every
//     corner's weight passes min_weight (and 0) and its tsdf signs are
//     mixed. A ballot gives the word of the active bitmask. An active
//     cell's 12-bit slot mask (slot 2j when tet j's four signs are mixed,
//     2j + 1 when two of them are negative) adds to the thread's slot
//     counts, which the block sums into the unit's 12 counts.
//  2. mt_scan_kernel: a block a (slab, slot) scans its units' counts
//     (int32, exclusive) and writes its total; the last block to finish
//     scans the totals (int64) and writes the triangle count, which the
//     host reads to size the output.
//  3. mt_emit_kernel: a block a unit. A thread reads a bitmask word (a
//     unit with no active cell ends there); a scan of the words' bit counts
//     lists the active cells in raster order in shared memory, and a thread
//     takes a listed cell: it reads its eight tsdf corners again and forms
//     its slot mask; for each slot a ballot ranks it within its warp and the
//     warps' counts before it within the block, and each triangle goes to
//     the unit's base for its slot plus that rank, where it is among the
//     first ``cap``. No atomics decide an order.
//
// Arithmetic: the plain version's float32 operations one for one
// (--fmad=false), as PyTorch runs them on the card: frac = clamp(where(|vb
// - va| > 1e-12, -va / (vb - va), 0.5), 0, 1) with IEEE division; the edge
// point (base + c_a) + frac (c_b - c_a); the reference point's integer sums
// over max(n_neg, 1); the cross product; d = (v0 + v1 + v2) / 3.0 - ref,
// where PyTorch's CUDA division by the Python scalar 3.0 multiplies by its
// float reciprocal (1.0f / 3.0f); dot = ((0 + n0 d0) + n1 d1) + n2 d2; the
// flip where dot < 0; the world point (v + 0.5) vs + origin. Every layout's
// corners are widened to float32 on load (common.cuh's storage), as
// vol.tsdf and vol.weight give them.
#include "common.cuh"

#define MT_ROWS 8    // y rows of cells a unit
#define MT_SLOTS 12
#define MT_BLOCK 256  // threads a block; an emit pass's bitmask words: a unit at 1024^3
#define MT_WARPS (MT_BLOCK / 32)

// The call's geometry: the volume's corners, the slab and the derived
// counts.
struct MtGrid {
  int nx, ny, nz;  // corners
  int slab;        // cells a slab along x
  int nzw;         // bitmask words a row of cells: (nz - 1) / 32 rounded up
  int units_y;     // units an x: (ny - 1) / MT_ROWS rounded up
  int ups;         // units a slab: slab * units_y
  int n_slabs;
};

static MtGrid mt_grid(int nx, int ny, int nz, int slab) {
  MtGrid g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.slab = slab;
  g.nzw = (nz - 1 + 31) / 32;
  g.units_y = (ny - 1 + MT_ROWS - 1) / MT_ROWS;
  g.ups = slab * g.units_y;
  g.n_slabs = (nx - 1 + slab - 1) / slab;
  return g;
}

// The six tetrahedra around the cube's 0-6 diagonal are (0, P, Q, 6); cube
// corner k sits at (dx, dy, dz) below (standard marching-cubes order).
__device__ __forceinline__ int mt_tet_p(int j) {
  return j == 0 ? 1 : j == 1 ? 2 : j == 2 ? 3 : j == 3 ? 7 : j == 4 ? 4 : 5;
}
__device__ __forceinline__ int mt_tet_q(int j) {
  return j == 0 ? 2 : j == 1 ? 3 : j == 2 ? 7 : j == 3 ? 4 : j == 4 ? 5 : 1;
}
__device__ __forceinline__ int mt_dx(int k) { return k == 1 || k == 2 || k == 5 || k == 6; }
__device__ __forceinline__ int mt_dy(int k) { return k == 2 || k == 3 || k == 6 || k == 7; }
__device__ __forceinline__ int mt_dz(int k) { return k >= 4; }

// The cell's 12-bit slot mask from its eight negative bits (bit k: corner
// k's tsdf < 0): slot 2j holds a triangle when tet j's signs are mixed,
// slot 2j + 1 when two of its four corners are negative.
__device__ __forceinline__ unsigned mt_slot_mask(unsigned nb) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const unsigned c = (nb & 1u) | (((nb >> mt_tet_p(j)) & 1u) << 1) |
                       (((nb >> mt_tet_q(j)) & 1u) << 2) | (((nb >> 6) & 1u) << 3);
    const int n = __popc(c);
    m |= (unsigned)(n >= 1 && n <= 3) << (2 * j);
    m |= (unsigned)(n == 2) << (2 * j + 1);
  }
  return m;
}

// Tet-local edge (a, b) and its id: (0,1) 0, (0,2) 1, (0,3) 2, (1,2) 3,
// (1,3) 4, (2,3) 5.
__device__ __forceinline__ int mt_edge_id(int a, int b) {
  const int lo = min(a, b), hi = max(a, b);
  return lo == 0 ? hi - 1 : lo == 1 ? hi + 1 : 5;
}
__device__ __forceinline__ int mt_edge_a(int e) { return e < 3 ? 0 : e < 5 ? 1 : 2; }
__device__ __forceinline__ int mt_edge_b(int e) { return e < 3 ? e + 1 : e < 5 ? e - 1 : 3; }

// Entry (case, k) of marching_cubes._build_tet_cases: the three edge ids
// of triangle k of sign case ``c``, 4 bits each (unused entries 0).
__device__ int mt_case_entry(int c, int k) {
  int in[4], out[4], ni = 0, no = 0;
  for (int l = 0; l < 4; ++l) {
    if (c & (1 << l)) {
      in[ni++] = l;
    } else {
      out[no++] = l;
    }
  }
  int e0 = 0, e1 = 0, e2 = 0;
  if (ni == 1) {
    e0 = mt_edge_id(in[0], out[0]);
    e1 = mt_edge_id(in[0], out[1]);
    e2 = mt_edge_id(in[0], out[2]);
  } else if (ni == 3) {
    e0 = mt_edge_id(out[0], in[0]);
    e1 = mt_edge_id(out[0], in[1]);
    e2 = mt_edge_id(out[0], in[2]);
  } else if (ni == 2) {
    const int q0 = mt_edge_id(in[0], out[0]), q1 = mt_edge_id(in[1], out[0]);
    const int q2 = mt_edge_id(in[1], out[1]), q3 = mt_edge_id(in[0], out[1]);
    e0 = q0;
    e1 = k ? q2 : q1;
    e2 = k ? q3 : q2;
  }
  return e0 | (e1 << 4) | (e2 << 8);
}

// ---------------------------------------------------------------------------
// 1. The active bitmask and each unit's slot counts.

// The flat index of corner k of the cell whose corner 0 is at ``a``.
__device__ __forceinline__ size_t mt_corner(const MtGrid& g, size_t a, int k) {
  return a + mt_dx(k) * (size_t)g.ny * g.nz + mt_dy(k) * (size_t)g.nz + mt_dz(k);
}

// The unit of block ``b``: its x, its first row, its rows and its index
// within its slab.
struct MtUnit {
  int x, slab, y0, rows;
  size_t index;
};

__device__ __forceinline__ MtUnit mt_unit(const MtGrid& g, int b) {
  MtUnit u;
  u.x = b / g.units_y;
  const int c = b % g.units_y;
  u.slab = u.x / g.slab;
  u.index = (size_t)(u.x - u.slab * g.slab) * g.units_y + c;
  u.y0 = c * MT_ROWS;
  u.rows = min(MT_ROWS, g.ny - 1 - u.y0);
  return u;
}

template <class S>
__global__ void __launch_bounds__(MT_BLOCK)
mt_classify_kernel(S vol, MtGrid g, float min_w, unsigned* __restrict__ bits,
                   int* __restrict__ counts) {
  __shared__ int s_cnt[MT_WARPS][MT_SLOTS];
  const MtUnit u = mt_unit(g, blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int cnt[MT_SLOTS];
#pragma unroll
  for (int s = 0; s < MT_SLOTS; ++s) cnt[s] = 0;
  for (int i = warp; i < u.rows * g.nzw; i += MT_WARPS) {
    const int y = u.y0 + i / g.nzw, word = i % g.nzw, z = word * 32 + lane;
    bool act = false;
    unsigned nb = 0;  // bit k: corner k's tsdf < 0
    if (z < g.nz - 1) {
      const size_t a = ((size_t)u.x * g.ny + y) * g.nz + z;
      bool ok = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float t, w;
        vol.load(mt_corner(g, a, k), t, w);
        ok = ok & (w >= min_w) & (w > 0.0f);
        nb |= (unsigned)(t < 0.0f) << k;
      }
      act = ok && nb != 0u && nb != 0xFFu;
    }
    const unsigned wv = __ballot_sync(HS_FULL_MASK, act);
    if (lane == 0) bits[((size_t)u.x * (g.ny - 1) + y) * g.nzw + word] = wv;
    if (act) {
      const unsigned sm = mt_slot_mask(nb);
#pragma unroll
      for (int s = 0; s < MT_SLOTS; ++s) cnt[s] += (sm >> s) & 1u;
    }
  }
  // the unit's counts (integer sums: any order)
#pragma unroll
  for (int s = 0; s < MT_SLOTS; ++s) {
    const int tot = (int)__reduce_add_sync(HS_FULL_MASK, (unsigned)cnt[s]);
    if (lane == 0) s_cnt[warp][s] = tot;
  }
  __syncthreads();
  if (threadIdx.x < MT_SLOTS) {
    int tot = 0;
    for (int w = 0; w < MT_WARPS; ++w) tot += s_cnt[w][threadIdx.x];
    counts[((size_t)u.slab * MT_SLOTS + threadIdx.x) * g.ups + u.index] = tot;
  }
}

// ---------------------------------------------------------------------------
// 2. The exclusive scans: units within each (slab, slot), then the (slab,
// slot) totals.

// Exclusive scan of ``own`` over the block, and the block's sum (every
// thread calls it).
__device__ __forceinline__ long long mt_block_exclusive(long long own, long long* s_warp,
                                                        long long& all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(HS_FULL_MASK, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  long long before = 0;
  all = 0;
  for (int k = 0; k < MT_WARPS; ++k) {
    before += k < warp ? s_warp[k] : 0;
    all += s_warp[k];
  }
  __syncthreads();
  return before + inc - own;
}

__global__ void __launch_bounds__(MT_BLOCK)
mt_scan_kernel(const int* __restrict__ counts, int ups, int* __restrict__ local,
               long long* tots, long long* __restrict__ base, int* done,
               long long* __restrict__ total) {
  __shared__ long long s_warp[MT_WARPS];
  __shared__ int s_last;
  const int b = blockIdx.x;
  const int per = (ups + MT_BLOCK - 1) / MT_BLOCK;
  const int lo = min(ups, (int)threadIdx.x * per), hi = min(ups, lo + per);
  const int* cb = counts + (size_t)b * ups;
  int* lb = local + (size_t)b * ups;
  long long own = 0;
  for (int i = lo; i < hi; ++i) own += cb[i];
  long long all;
  long long run = mt_block_exclusive(own, s_warp, all);
  for (int i = lo; i < hi; ++i) {
    lb[i] = (int)run;
    run += cb[i];
  }
  if (threadIdx.x == 0) {
    tots[b] = all;
    __threadfence();
    s_last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: the (slab, slot) bases
  __threadfence();
  const int n = gridDim.x, per2 = (n + MT_BLOCK - 1) / MT_BLOCK;
  const int lo2 = min(n, (int)threadIdx.x * per2), hi2 = min(n, lo2 + per2);
  const volatile long long* vt = tots;
  own = 0;
  for (int i = lo2; i < hi2; ++i) own += vt[i];
  run = mt_block_exclusive(own, s_warp, all);
  for (int i = lo2; i < hi2; ++i) {
    base[i] = run;
    run += vt[i];
  }
  if (threadIdx.x == 0) *total = all;
}

// ---------------------------------------------------------------------------
// 3. The triangles, each at its place in the soup.

// t[i] of a cell's eight corners, with no local-memory index.
__device__ __forceinline__ float mt_sel8(const float (&t)[8], int i) {
  float v = t[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = i == k ? t[k] : v;
  return v;
}

// The point on tet edge ``e`` (the tet's corner values v and cube corner
// offsets c) of the cell at base: _cell_triangles' edge_pts row.
__device__ __forceinline__ void mt_edge_point(int e, const float (&v)[4], const float (&c)[4][3],
                                              const float (&base)[3], float (&p)[3]) {
  const int ia = mt_edge_a(e), ib = mt_edge_b(e);
  const float va = ia == 0 ? v[0] : ia == 1 ? v[1] : v[2];
  const float vb = ib == 1 ? v[1] : ib == 2 ? v[2] : v[3];
  const float denom = vb - va;
  const bool big = fabsf(denom) > 1e-12f;
  const float q = -va / (big ? denom : 1.0f);
  const float frac = hs_clamp_max(hs_clamp_min(big ? q : 0.5f, 0.0f), 1.0f);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ca = ia == 0 ? c[0][d] : ia == 1 ? c[1][d] : c[2][d];
    const float cb = ib == 1 ? c[1][d] : ib == 2 ? c[2][d] : c[3][d];
    p[d] = (base[d] + ca) + frac * (cb - ca);
  }
}

// Triangle k of tet j of a cell (corners t, at base), oriented and in
// world coordinates: the nine floats of its row in the soup.
__device__ __forceinline__ void mt_triangle(float* __restrict__ o, const float (&t)[8], int j,
                                            int k, const float (&base)[3], const int* s_cases,
                                            const float (&org)[3], float vs) {
  const int p = mt_tet_p(j), q = mt_tet_q(j);
  const float v[4] = {t[0], mt_sel8(t, p), mt_sel8(t, q), t[6]};
  const float c[4][3] = {{0.0f, 0.0f, 0.0f},
                         {(float)mt_dx(p), (float)mt_dy(p), (float)mt_dz(p)},
                         {(float)mt_dx(q), (float)mt_dy(q), (float)mt_dz(q)},
                         {1.0f, 1.0f, 1.0f}};
  const int cs = (int)((v[0] < 0.0f) | ((v[1] < 0.0f) << 1) | ((v[2] < 0.0f) << 2) |
                       ((v[3] < 0.0f) << 3));
  // the reference point inside the negative region, for the orientation
  float nf[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) nf[l] = v[l] < 0.0f ? 1.0f : 0.0f;
  const float n_neg = ((nf[0] + nf[1]) + nf[2]) + nf[3];
  float ref[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float r = 0.0f;
#pragma unroll
    for (int l = 0; l < 4; ++l) r = r + (base[d] + c[l][d]) * nf[l];
    ref[d] = r / hs_clamp_min(n_neg, 1.0f);
  }
  const int ent = s_cases[cs * 2 + k];
  float p0[3], p1[3], p2[3];
  mt_edge_point(ent & 15, v, c, base, p0);
  mt_edge_point((ent >> 4) & 15, v, c, base, p1);
  mt_edge_point((ent >> 8) & 15, v, c, base, p2);
  float e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e1[d] = p1[d] - p0[d];
    e2[d] = p2[d] - p0[d];
  }
  const float n0 = e1[1] * e2[2] - e1[2] * e2[1];
  const float n1 = e1[2] * e2[0] - e1[0] * e2[2];
  const float n2 = e1[0] * e2[1] - e1[1] * e2[0];
  const float third = 1.0f / 3.0f;
  const float d0 = ((p0[0] + p1[0]) + p2[0]) * third - ref[0];
  const float d1 = ((p0[1] + p1[1]) + p2[1]) * third - ref[1];
  const float d2 = ((p0[2] + p1[2]) + p2[2]) * third - ref[2];
  const float dot = ((0.0f + n0 * d0) + n1 * d1) + n2 * d2;
  const bool flip = dot < 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    o[d] = (p0[d] + 0.5f) * vs + org[d];
    o[3 + d] = ((flip ? p2[d] : p1[d]) + 0.5f) * vs + org[d];
    o[6 + d] = ((flip ? p1[d] : p2[d]) + 0.5f) * vs + org[d];
  }
}

template <class S>
__global__ void __launch_bounds__(MT_BLOCK)
mt_emit_kernel(S vol, MtGrid g, const unsigned* __restrict__ bits, const int* __restrict__ local,
               const long long* __restrict__ base, const float* __restrict__ params,
               long long cap, float* __restrict__ out) {
  __shared__ long long s_base[MT_SLOTS];  // each slot's next place in the soup
  __shared__ int s_cases[32];
  __shared__ int s_cnt[MT_WARPS][MT_SLOTS];
  __shared__ long long s_scan[MT_WARPS];
  __shared__ unsigned short s_list[32 * MT_BLOCK];  // a pass's active cells, in order
  const MtUnit u = mt_unit(g, blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_words = u.rows * g.nzw;
  const unsigned* unit_bits = bits + ((size_t)u.x * (g.ny - 1) + u.y0) * g.nzw;
  bool based = false;
  for (int w0 = 0; w0 < n_words; w0 += MT_BLOCK) {
    const int i = w0 + threadIdx.x;
    const unsigned word = i < n_words ? unit_bits[i] : 0u;
    if (!__syncthreads_or(word != 0u)) continue;  // a unit with no active cell ends here
    if (!based) {  // the unit's first active pass: its bases and the case table
      if (threadIdx.x < MT_SLOTS) {
        const size_t ss = (size_t)u.slab * MT_SLOTS + threadIdx.x;
        s_base[threadIdx.x] = base[ss] + local[ss * g.ups + u.index];
      } else if (threadIdx.x < MT_SLOTS + 32) {
        const int e = threadIdx.x - MT_SLOTS;
        s_cases[e] = mt_case_entry(e >> 1, e & 1);
      }
      based = true;
    }
    // the pass's active cells listed in raster order: word, then bit
    long long n_all;
    int k = (int)mt_block_exclusive(__popc(word), s_scan, n_all);
    const int n_act = (int)n_all;
    for (unsigned m = word; m; m &= m - 1u) s_list[k++] = (unsigned short)(threadIdx.x * 32 + __ffs(m) - 1);
    __syncthreads();
    const float org[3] = {params[0], params[1], params[2]};
    const float vs = params[3];
    // a thread a listed cell: its slot mask, each slot's rank, its triangles
    for (int c0 = 0; c0 < n_act; c0 += MT_BLOCK) {
      const int j = c0 + threadIdx.x;
      float t[8];
      unsigned sm = 0;
      int y = 0, z = 0;
      if (j < n_act) {
        const int pos = s_list[j], wi = w0 + (pos >> 5);
        y = u.y0 + wi / g.nzw;
        z = (wi % g.nzw) * 32 + (pos & 31);
        const size_t a = ((size_t)u.x * g.ny + y) * g.nz + z;
        unsigned nb = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float w;
          vol.load(mt_corner(g, a, q), t[q], w);
          nb |= (unsigned)(t[q] < 0.0f) << q;
        }
        sm = mt_slot_mask(nb);
      }
      // the warp's cells in each slot; the warps before this one come from
      // their counts
#pragma unroll
      for (int s = 0; s < MT_SLOTS; ++s) {
        const unsigned b = __ballot_sync(HS_FULL_MASK, (sm >> s) & 1u);
        if (lane == 0) s_cnt[warp][s] = __popc(b);
      }
      __syncthreads();
      const float b3[3] = {(float)u.x, (float)y, (float)z};
      for (int s = 0; s < MT_SLOTS; ++s) {
        const unsigned b = __ballot_sync(HS_FULL_MASK, (sm >> s) & 1u);
        if ((sm >> s) & 1u) {
          long long idx = s_base[s] + __popc(b & ((1u << lane) - 1u));
          for (int w = 0; w < warp; ++w) idx += s_cnt[w][s];
          if (idx < cap) mt_triangle(out + idx * 9, t, s >> 1, s & 1, b3, s_cases, org, vs);
        }
      }
      __syncthreads();  // every thread has read this chunk's bases and counts
      if (threadIdx.x < MT_SLOTS) {
        for (int w = 0; w < MT_WARPS; ++w) s_base[threadIdx.x] += s_cnt[w][threadIdx.x];
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------

static size_t mt_align(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// Byte offsets of one call's scratch regions, and its size: the bitmask,
// the units' counts and the finish counter (zeroed together), the units'
// offsets within their (slab, slot), the (slab, slot) totals and bases.
struct MtScratch {
  size_t bits, counts, local, tots, base, bytes;
  long long n_counts;
  int n_ss;
};

static MtScratch mt_scratch(const MtGrid& g) {
  MtScratch s;
  s.n_ss = g.n_slabs * MT_SLOTS;
  s.n_counts = (long long)s.n_ss * g.ups;
  size_t o = 0;
  s.bits = o;
  o += mt_align((size_t)(g.nx - 1) * (g.ny - 1) * g.nzw * sizeof(unsigned));
  s.counts = o;
  o += mt_align((size_t)(s.n_counts + 1) * sizeof(int));
  s.local = o;
  o += mt_align((size_t)s.n_counts * sizeof(int));
  s.tots = o;
  o += mt_align((size_t)s.n_ss * sizeof(long long));
  s.base = o;
  o += mt_align((size_t)s.n_ss * sizeof(long long));
  s.bytes = o;
  return s;
}

static bool mt_valid(int nx, int ny, int nz, int slab) {
  return nx >= 2 && ny >= 2 && nz >= 2 && slab >= 1 && slab <= nx - 1;
}

// A block a unit: both the classify and the emit grid.
static long long mt_blocks(const MtGrid& g) { return (long long)(g.nx - 1) * g.units_y; }

// out[0]: the scratch bytes of a call on an nx x ny x nz volume with
// ``slab`` cells a slab (1 <= slab <= nx - 1).
extern "C" int hs_marching_tets_scratch(int nx, int ny, int nz, int slab, long long* out) {
  if (!mt_valid(nx, ny, nz, slab)) return (int)cudaErrorInvalidValue;
  out[0] = (long long)mt_scratch(mt_grid(nx, ny, nz, slab)).bytes;
  return 0;
}

template <class S>
static int mt_count(S vol, const MtGrid& g, float min_w, char* scratch, long long* total,
                    cudaStream_t st) {
  const MtScratch s = mt_scratch(g);
  int* counts = reinterpret_cast<int*>(scratch + s.counts);
  // a last slab narrower than ``slab`` leaves units no block writes
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)(s.n_counts + 1) * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (mt_blocks(g) > 0x7FFFFFFFLL || g.ups > 0x7FFFFFFF / MT_SLOTS) return (int)cudaErrorInvalidValue;
  mt_classify_kernel<S><<<(unsigned)mt_blocks(g), MT_BLOCK, 0, st>>>(
      vol, g, min_w, reinterpret_cast<unsigned*>(scratch + s.bits), counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mt_scan_kernel<<<s.n_ss, MT_BLOCK, 0, st>>>(
      counts, g.ups, reinterpret_cast<int*>(scratch + s.local),
      reinterpret_cast<long long*>(scratch + s.tots), reinterpret_cast<long long*>(scratch + s.base),
      counts + s.n_counts, total);
  return (int)cudaGetLastError();
}

// Steps 1 and 2: vol is the packed (nx, ny, nz) int32 grid (layout
// HS_LAYOUT_PACKED) or the (2, nx, ny, nz) float32 or bfloat16 array;
// scratch: the bytes hs_marching_tets_scratch gives; writes the triangle
// count to total[0] (device memory).
extern "C" int hs_marching_tets_count(void* vol, int layout, int nx, int ny, int nz, int slab,
                                      float min_w, void* scratch, long long* total,
                                      void* stream) {
  if (!mt_valid(nx, ny, nz, slab)) return (int)cudaErrorInvalidValue;
  const MtGrid g = mt_grid(nx, ny, nz, slab);
  const cudaStream_t st = (cudaStream_t)stream;
  char* sc = static_cast<char*>(scratch);
  const size_t plane = (size_t)nx * ny * nz;
  if (layout == HS_LAYOUT_PACKED) return mt_count(HsPacked{(int*)vol}, g, min_w, sc, total, st);
  if (layout == HS_LAYOUT_F32)
    return mt_count(HsPlanar<float>{(float*)vol, plane}, g, min_w, sc, total, st);
  if (layout == HS_LAYOUT_BF16)
    return mt_count(HsPlanar<__nv_bfloat16>{(__nv_bfloat16*)vol, plane}, g, min_w, sc, total,
                    st);
  return (int)cudaErrorInvalidValue;
}

template <class S>
static int mt_emit(S vol, const MtGrid& g, const float* params, char* scratch, long long cap,
                   float* out, cudaStream_t st) {
  const MtScratch s = mt_scratch(g);
  if (mt_blocks(g) > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mt_emit_kernel<S><<<(unsigned)mt_blocks(g), MT_BLOCK, 0, st>>>(
      vol, g, reinterpret_cast<const unsigned*>(scratch + s.bits),
      reinterpret_cast<const int*>(scratch + s.local),
      reinterpret_cast<const long long*>(scratch + s.base), params, cap, out);
  return (int)cudaGetLastError();
}

// Step 3, after hs_marching_tets_count on the same scratch: params is
// (origin x, y, z, voxel size), float32 on the device; out holds ``cap``
// rows of 9 floats (v0, v1, v2 xyz), the first ``cap`` triangles of the
// soup.
extern "C" int hs_marching_tets_emit(void* vol, int layout, int nx, int ny, int nz, int slab,
                                     const float* params, void* scratch, long long cap,
                                     float* out, void* stream) {
  if (!mt_valid(nx, ny, nz, slab)) return (int)cudaErrorInvalidValue;
  if (cap <= 0) return 0;
  const MtGrid g = mt_grid(nx, ny, nz, slab);
  const cudaStream_t st = (cudaStream_t)stream;
  char* sc = static_cast<char*>(scratch);
  const size_t plane = (size_t)nx * ny * nz;
  if (layout == HS_LAYOUT_PACKED)
    return mt_emit(HsPacked{(int*)vol}, g, params, sc, cap, out, st);
  if (layout == HS_LAYOUT_F32)
    return mt_emit(HsPlanar<float>{(float*)vol, plane}, g, params, sc, cap, out, st);
  if (layout == HS_LAYOUT_BF16)
    return mt_emit(HsPlanar<__nv_bfloat16>{(__nv_bfloat16*)vol, plane}, g, params, sc, cap, out,
                   st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM: out[0..2] classify packed, float32, bfloat16;
// out[3] scan; out[4..6] emit packed, float32, bfloat16.
extern "C" int hs_marching_tets_occupancy(int, int* out) {
  int e = hs_occupancy(mt_classify_kernel<HsPacked>, MT_BLOCK, 0, out);
  if (!e) e = hs_occupancy(mt_classify_kernel<HsPlanar<float>>, MT_BLOCK, 0, out + 1);
  if (!e) e = hs_occupancy(mt_classify_kernel<HsPlanar<__nv_bfloat16>>, MT_BLOCK, 0, out + 2);
  if (!e) e = hs_occupancy(mt_scan_kernel, MT_BLOCK, 0, out + 3);
  if (!e) e = hs_occupancy(mt_emit_kernel<HsPacked>, MT_BLOCK, 0, out + 4);
  if (!e) e = hs_occupancy(mt_emit_kernel<HsPlanar<float>>, MT_BLOCK, 0, out + 5);
  return e ? e : hs_occupancy(mt_emit_kernel<HsPlanar<__nv_bfloat16>>, MT_BLOCK, 0,
                              out + 6);
}
