// K9: the work-list prepass of the streaming TSDF integrate, three
// launches a step. It replaces no Pallas kernel: the JAX package computes
// this prepass (housescan_tpu/ops/chunk_select.py build_worklist, with
// free_split) as XLA array code. The port's plain version
// (housescan_tpu_torch/ops/chunk_select.py build_worklist) takes about
// 1,500 small tensor operations a step at 12-15 us of host dispatch each,
// which held the fusion step to the host; these kernels give the same
// lists, bit for bit, from three launches and no host synchronisation.
//
// Bound: the depth image read once, planes field 11 (five flags) read
// once a chunk, the work list (32 bytes a chunk) and the free list (16
// bytes a superblock) written once: about 2 MB at 640x480 and a 512^3
// volume, under a microsecond at 3.35 TB/s; the arithmetic (~1,000 float
// operations a chunk: 40 corner projections, four footprint look-ups) is
// below that. What holds it is latency: a few dependent rounds of memory
// reads a launch over a few thousand threads. So each launch is one pass,
// with no atomics and nothing that needs zeroing first.
//
// Design.
//  1. chunk_hiz_kernel: a block of 512 threads a tile of 16 x 16 level-0
//     cells (128 x 128 pixels). Two threads a cell read its 8 x 8 pixels,
//     four rows each (a half-warp reads one 512-byte row segment), giving
//     its valid-min, max and all-valid; levels 1-4 are the tile's own 2 x 2
//     reductions in shared memory (a level-4 cell is the whole tile), with
//     build_hiz's padding where a level's edge is odd. The block also folds
//     the image-wide valid-min, any-valid and all-valid of its pixels (and
//     of a share of those past the last whole cell) into one partial,
//     which the next kernel reduces. The 3 x 3 dilation is no pass of its
//     own: a look-up takes the min / max over the in-bounds neighbours,
//     which is max_pool2d's -inf padding. Min and max are exact in any
//     order.
//  2. chunk_classify_kernel: a thread a chunk. With the free split a
//     half-warp holds one superblock's 16 chunks, lane qi * 4 + qj, so the
//     superblock test (it lists a chunk, and every chunk it lists is FREE
//     with no negative flag) is a ballot. The saturation and negative flags
//     come straight from planes field 11. It writes each chunk's
//     descriptor row and listed flag to scratch, and each superblock's
//     member bitmap and flag.
//  3. chunk_compact_kernel: the stable partition. Each block counts the
//     listed flags before its 1,024 chunks (a popcount over the flag
//     words, 16 KB at 512^3) and the total, then scatters its rows: listed
//     rows in raster order from row 0, skipped ones from the total. One
//     more block lists the superblocks and pads the free list with its
//     last entry (zeros when none is listed).
//
// Arithmetic: the plain version's float32 operations one for one
// (--fmad=false): x0 + dx vs - t in that order, left-to-right dot
// products, fx xc / safe + cx; torch.minimum / maximum / clamp keep a NaN,
// as cs_min, cs_max and cs_clamp do. ceil(log2(max(span, 1) / 8))
// clamped to 0..4 is taken as the least l with max(span, 1) <= 8 2^l,
// capped at 4: the same integer as PyTorch's float32 log2 at the powers of
// two (tests/test_torch_gpu.py holds the two together on the card).
#include "common.cuh"

#define CS_BIG 1.0e9f
#define CS_LEVELS 5
#define CS_TILE 16          // level-0 cells a side of a hiz tile: a level-4 cell
#define CS_TILE_CELLS 341   // 16^2 + 8^2 + 4^2 + 2^2 + 1: the tile's cells of levels 0-4
#define CS_HIZ_THREADS 512  // two a level-0 cell of the tile
#define CS_CLS_THREADS 128  // a thread a chunk: eight superblocks a block
#define CS_CMP_THREADS 256
#define CS_SEG 1024         // chunks a compact block
#define CS_PLANES_TILE 256  // (N_FIELDS, NSUB_C) = (16, 16) planes tile of a chunk
#define CS_FIELD_SAT 176    // field 11, column 0 of the tile

// The hiz pyramid's level dims (build_hiz: level 0 is (h / 8, w / 8), each
// next level halves rounding up) and offsets in the flattened table, and
// the tiles of kernel 1.
struct CsLevels {
  int rows[CS_LEVELS], cols[CS_LEVELS], offs[CS_LEVELS];
  int total, tiles_c, n_tiles;
};

// The band window's origin caps a level (mip height - 32, width - 128;
// level 3 reads the whole image: 0).
struct CsWin {
  int v_hi[4], u_hi[4];
};

// A quarter's or a z-plane's projected extremes.
struct CsExt {
  float zmin, zmax, umin, umax, vmin, vmax;
};

static CsLevels cs_levels(int h, int w) {
  CsLevels L;
  int r = h / 8, c = w / 8, off = 0;
  for (int l = 0; l < CS_LEVELS; ++l) {
    if (l) {
      r = (r + 1) / 2;
      c = (c + 1) / 2;
    }
    L.rows[l] = r;
    L.cols[l] = c;
    L.offs[l] = off;
    off += r * c;
  }
  L.total = off;
  L.tiles_c = (L.cols[0] + CS_TILE - 1) / CS_TILE;
  L.n_tiles = L.tiles_c * ((L.rows[0] + CS_TILE - 1) / CS_TILE);
  return L;
}

// torch.minimum / torch.maximum: NaN if either operand is.
__device__ __forceinline__ float cs_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float cs_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
// torch.clamp(x, lo, hi): a NaN stays.
__device__ __forceinline__ float cs_clamp(float x, float lo, float hi) {
  return hs_clamp_max(hs_clamp_min(x, lo), hi);
}

// ---------------------------------------------------------------------------
// 1. The hiz pyramid (raw, undilated) and the image-wide partials.

__global__ void __launch_bounds__(CS_HIZ_THREADS)
chunk_hiz_kernel(const float* __restrict__ depth, int h, int w, CsLevels L,
                 float* __restrict__ hiz, int* __restrict__ partials) {
  __shared__ float s_mn[CS_TILE_CELLS], s_mx[CS_TILE_CELLS], s_al[CS_TILE_CELLS];
  __shared__ float s_red[CS_HIZ_THREADS / 32];
  const int tr = blockIdx.x / L.tiles_c, tc = blockIdx.x % L.tiles_c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lc = lane & 15, half = lane >> 4;
  const int R = tr * CS_TILE + warp, C = tc * CS_TILE + lc;  // the thread's level-0 cell
  const bool cell = R < L.rows[0] && C < L.cols[0];

  // per pixel: min of (valid ? d : BIG), max of (valid ? d : 0), all / any valid
  float mn = INFINITY, mx = -INFINITY;
  bool all = true, any = false;
  if (cell) {
    const bool vec = ((reinterpret_cast<uintptr_t>(depth) | ((size_t)w * 4)) & 15) == 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* row = depth + (size_t)(R * 8 + half * 4 + k) * w + C * 8;
      float d[8];
      if (vec) {
        const float4 a = reinterpret_cast<const float4*>(row)[0];
        const float4 b = reinterpret_cast<const float4*>(row)[1];
        d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
        d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = row[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool v = d[j] > 0.0f;
        mn = fminf(mn, v ? d[j] : CS_BIG);
        mx = fmaxf(mx, v ? d[j] : 0.0f);
        all = all && v;
        any = any || v;
      }
    }
  }
  const float cmn = fminf(mn, __shfl_xor_sync(HS_FULL_MASK, mn, 16));
  const float cmx = fmaxf(mx, __shfl_xor_sync(HS_FULL_MASK, mx, 16));
  const bool call = __shfl_xor_sync(HS_FULL_MASK, (int)all, 16) && all;
  if (cell && half == 0) {
    const int i = warp * CS_TILE + lc;
    s_mn[i] = cmn;
    s_mx[i] = cmx;
    s_al[i] = call ? 1.0f : 0.0f;
    const int g = L.offs[0] + R * L.cols[0] + C;
    hiz[g] = cmn;
    hiz[L.total + g] = cmx;
    hiz[2 * L.total + g] = s_al[i];
  }

  // pixels past the last whole cell count in the image-wide values only:
  // the columns right of it above, then the rows below it
  const int h8 = L.rows[0] * 8, w8 = L.cols[0] * 8;
  const long long n_right = (long long)h8 * (w - w8);
  const long long n_rem = n_right + (long long)(h - h8) * w;
  for (long long i = (long long)blockIdx.x * CS_HIZ_THREADS + threadIdx.x; i < n_rem;
       i += (long long)gridDim.x * CS_HIZ_THREADS) {
    long long y, x;
    if (i < n_right) {
      y = i / (w - w8);
      x = w8 + i % (w - w8);
    } else {
      y = h8 + (i - n_right) / w;
      x = (i - n_right) % w;
    }
    const float d = depth[y * w + x];
    const bool v = d > 0.0f;
    mn = fminf(mn, v ? d : CS_BIG);
    all = all && v;
    any = any || v;
  }
  __syncthreads();

  // levels 1-4 of the tile: min, max and min over 2 x 2 children, a child
  // past the level's edge reading build_hiz's padding (BIG, 0, BIG)
  int so_prev = 0, so = CS_TILE * CS_TILE, nl = CS_TILE;
  for (int l = 1; l < CS_LEVELS; ++l) {
    const int nc = nl;  // the children's tile side
    nl >>= 1;
    if ((int)threadIdx.x < nl * nl) {
      const int i = threadIdx.x / nl, j = threadIdx.x % nl;
      const int gi = tr * nl + i, gj = tc * nl + j;
      if (gi < L.rows[l] && gj < L.cols[l]) {
        float a = INFINITY, b = -INFINITY, c = INFINITY;
#pragma unroll
        for (int di = 0; di < 2; ++di) {
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const bool has = 2 * gi + di < L.rows[l - 1] && 2 * gj + dj < L.cols[l - 1];
            const int k = so_prev + (2 * i + di) * nc + 2 * j + dj;
            a = fminf(a, has ? s_mn[k] : CS_BIG);
            b = fmaxf(b, has ? s_mx[k] : 0.0f);
            c = fminf(c, has ? s_al[k] : CS_BIG);
          }
        }
        s_mn[so + threadIdx.x] = a;
        s_mx[so + threadIdx.x] = b;
        s_al[so + threadIdx.x] = c;
        const int g = L.offs[l] + gi * L.cols[l] + gj;
        hiz[g] = a;
        hiz[L.total + g] = b;
        hiz[2 * L.total + g] = c;
      }
    }
    __syncthreads();
    so_prev = so;
    so += nl * nl;
  }

  const int g_any = __syncthreads_or(any), g_all = __syncthreads_and(all);
  const float m = hs_warp_min(mn);
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = s_red[0];
    for (int k = 1; k < CS_HIZ_THREADS / 32; ++k) r = fminf(r, s_red[k]);
    partials[4 * blockIdx.x] = __float_as_int(r);
    partials[4 * blockIdx.x + 1] = g_any;
    partials[4 * blockIdx.x + 2] = g_all;
  }
}

// ---------------------------------------------------------------------------
// 2. A thread a chunk: its class, window and listing.

// The four corners (dx, dy in {0, 8} voxels) of a chunk's z-plane dzq
// voxels up, projected as build_worklist's project_zplane: their extremes.
__device__ __forceinline__ CsExt cs_zplane(const float* p, float x0, float y0, float z0,
                                           float dzq) {
  const float vs = p[17];
  CsExt e;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = (k >> 1) ? 8.0f : 0.0f, dy = (k & 1) ? 8.0f : 0.0f;
    const float wx = x0 + dx * vs - p[9];
    const float wy = y0 + dy * vs - p[10];
    const float wz = z0 + dzq * vs - p[11];
    const float xc = wx * p[0] + wy * p[1] + wz * p[2];
    const float yc = wx * p[3] + wy * p[4] + wz * p[5];
    const float zc = wx * p[6] + wy * p[7] + wz * p[8];
    const float safe = hs_clamp_min(zc, 1e-6f);
    const float uf = p[12] * xc / safe + p[14];
    const float vf = p[13] * yc / safe + p[15];
    if (k == 0) {
      e = {zc, zc, uf, uf, vf, vf};
    } else {
      e.zmin = cs_min(e.zmin, zc);
      e.zmax = cs_max(e.zmax, zc);
      e.umin = cs_min(e.umin, uf);
      e.umax = cs_max(e.umax, uf);
      e.vmin = cs_min(e.vmin, vf);
      e.vmax = cs_max(e.vmax, vf);
    }
  }
  return e;
}

// build_worklist's fp_stats of a quarter's image box: the dilated footprint
// depth min, max and all-valid at the level whose cell covers the box, and
// whether the box fits a level-4 cell.
__device__ __forceinline__ void cs_footprint(const float* __restrict__ hiz, const CsLevels& L,
                                             float w1, float h1, const CsExt& q, float& fmin,
                                             float& fmax, bool& fall, bool& fit) {
  const float cumin = cs_clamp(q.umin, 0.0f, w1), cumax = cs_clamp(q.umax, 0.0f, w1);
  const float cvmin = cs_clamp(q.vmin, 0.0f, h1), cvmax = cs_clamp(q.vmax, 0.0f, h1);
  const float span = cs_max(cumax - cumin, cvmax - cvmin);
  const float s1 = hs_clamp_min(span, 1.0f);
  const int l = s1 <= 8.0f ? 0 : s1 <= 16.0f ? 1 : s1 <= 32.0f ? 2 : s1 <= 64.0f ? 3 : 4;
  fit = span <= 8.0f * 16.0f;
  const float cell = (float)(8 << l);
  const float cu = (cumin + cumax) * 0.5f, cv = (cvmin + cvmax) * 0.5f;
  const int nr = L.rows[l], nc = L.cols[l];
  const int rr = min(max((int)(cv / cell), 0), nr - 1);
  const int cc = min(max((int)(cu / cell), 0), nc - 1);
  const float* tmin = hiz + L.offs[l];
  const float* tmax = tmin + L.total;
  const float* tall = tmax + L.total;
  float a = tmin[rr * nc + cc], b = tmax[rr * nc + cc], c = tall[rr * nc + cc];
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const int r = rr + dr;
    if (r < 0 || r >= nr) continue;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const int k = cc + dc;
      if (k < 0 || k >= nc || (dr == 0 && dc == 0)) continue;
      a = fminf(a, tmin[r * nc + k]);
      b = fmaxf(b, tmax[r * nc + k]);
      c = fminf(c, tall[r * nc + k]);
    }
  }
  fmin = a;
  fmax = b;
  fall = c > 0.5f;
}

__global__ void __launch_bounds__(CS_CLS_THREADS)
chunk_classify_kernel(const float* __restrict__ p, const float* __restrict__ planes,
                      const float* __restrict__ hiz, const int* __restrict__ partials,
                      CsLevels L, CsWin win, int nbx, int nby, int nzc, int split, int n_pad,
                      int* __restrict__ rows, unsigned char* __restrict__ flags,
                      unsigned char* __restrict__ sb_flags, int* __restrict__ sb_bitmap) {
  __shared__ float s_dmin;
  __shared__ int s_any, s_all;
  if (threadIdx.x < 32) {
    float dm = INFINITY;
    int an = 0, al = 1;
    for (int k = threadIdx.x; k < L.n_tiles; k += 32) {
      dm = fminf(dm, __int_as_float(partials[4 * k]));
      an |= partials[4 * k + 1];
      al &= partials[4 * k + 2];
    }
    dm = hs_warp_min(dm);
    an = __any_sync(HS_FULL_MASK, an);
    al = __all_sync(HS_FULL_MASK, al);
    if (threadIdx.x == 0) {
      s_dmin = dm;
      s_any = an;
      s_all = al;
    }
  }
  __syncthreads();

  const int n = nbx * nby * nzc;
  const int t = blockIdx.x * CS_CLS_THREADS + threadIdx.x;
  const bool live = t < n;
  int ci, cj, ck;
  if (split) {  // t = superblock * 16 + qi * 4 + qj
    const int nsy = nby / 4, sb = t >> 4, m = t & 15;
    ci = 4 * (sb / (nsy * nzc)) + (m >> 2);
    cj = 4 * ((sb / nzc) % nsy) + (m & 3);
    ck = sb % nzc;
  } else {
    ci = t / (nby * nzc);
    cj = (t / nzc) % nby;
    ck = t % nzc;
  }
  const int id = (ci * nby + cj) * nzc + ck;

  bool skip = true, free_c = false, neg = false;
  int cls = 0, level = 3, v0 = 0, u0 = 0;
  if (live) {
    const float vs = p[17], trunc = p[16];
    const float w1 = p[22] - 1.0f, h1 = p[23] - 1.0f;
    const int bx0 = (int)p[26];  // a slab's first global X block: world x only
    const float x0 = p[18] + (float)(ci + bx0) * (8.0f * vs);
    const float y0 = p[19] + (float)cj * (8.0f * vs);
    const float z0 = p[20] + (float)ck * (128.0f * vs);
    CsExt pl[5];
#pragma unroll
    for (int z = 0; z < 5; ++z) pl[z] = cs_zplane(p, x0, y0, z0, 32.0f * z);
    const float* flag = planes + (size_t)id * CS_PLANES_TILE + CS_FIELD_SAT;

    bool any_inc = false, all_free = true, all_behind = true, eff_any = false, eff_clean = true;
    float umin = CS_BIG, umax = -CS_BIG, vmin = CS_BIG, vmax = -CS_BIG;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const CsExt& a = pl[q];
      const CsExt& b = pl[q + 1];
      CsExt e;
      e.zmin = cs_min(cs_min(CS_BIG, a.zmin), b.zmin);
      e.zmax = cs_max(cs_max(-CS_BIG, a.zmax), b.zmax);
      e.umin = cs_min(cs_min(CS_BIG, a.umin), b.umin);
      e.umax = cs_max(cs_max(-CS_BIG, a.umax), b.umax);
      e.vmin = cs_min(cs_min(CS_BIG, a.vmin), b.vmin);
      e.vmax = cs_max(cs_max(-CS_BIG, a.vmax), b.vmax);
      const bool clean = e.zmin > 1e-6f;
      const bool out = e.zmax <= 1e-6f ||
                       (clean && (e.umax < 0.0f || e.umin > w1 || e.vmax < 0.0f || e.vmin > h1));
      if (out) continue;  // an excluded quarter changes nothing below
      any_inc = true;
      float fmin, fmax;
      bool fall, fit;
      cs_footprint(hiz, L, w1, h1, e, fmin, fmax, fall, fit);
      const bool tight = clean && fit;
      bool behind = tight && (e.zmin - trunc > fmax);
      const bool free_t = (e.zmax + trunc < fmin) && (fmax > 0.0f) && fall;
      const bool free_g = (e.zmax + trunc < s_dmin) && s_all && s_any;
      const bool free_q = tight ? free_t : free_g;
      all_free = all_free && free_q;
      all_behind = all_behind && behind;
      behind = behind || (free_q && flag[q] > 0.5f);
      if (!behind) {
        eff_any = true;
        umin = cs_min(umin, e.umin);
        umax = cs_max(umax, e.umax);
        vmin = cs_min(vmin, e.vmin);
        vmax = cs_max(vmax, e.vmax);
        eff_clean = eff_clean && clean;
      }
    }
    skip = !any_inc || all_behind || !eff_any;
    free_c = any_inc && all_free;
    const bool clean_c = eff_any && eff_clean;
    cls = free_c ? 0 : (clean_c ? 1 : 3);
    neg = flag[4] > 0.5f;

    // band window: level l fits iff span_v <= 22 2^l and span_u <= 60 2^l
    const float cumin = cs_clamp(umin, 0.0f, w1), cumax = cs_clamp(umax, 0.0f, w1);
    const float cvmin = cs_clamp(vmin, 0.0f, h1), cvmax = cs_clamp(vmax, 0.0f, h1);
    const float su = cumax - cumin, sv = cvmax - cvmin;
    level = (sv <= 22.0f && su <= 60.0f)     ? 0
            : (sv <= 44.0f && su <= 120.0f) ? 1
            : (sv <= 88.0f && su <= 240.0f) ? 2
                                            : 3;
    if (!clean_c) level = 3;
    if (level < 3) {
      const float scale = (float)(1 << level);
      v0 = min(max(((int)(cvmin / scale) - 1) & ~7, 0), win.v_hi[level]);
      u0 = min(max(((int)(cumin / scale) - 1) & ~63, 0), win.u_hi[level]);
    }
  }

  if (split) {
    const bool free_ok = live && free_c && !skip && !neg;
    const bool blocker = live && !skip && !free_ok;  // listed chunks the free carve cannot take
    const int sh = threadIdx.x & 16;
    const unsigned ok = (__ballot_sync(HS_FULL_MASK, free_ok) >> sh) & 0xFFFFu;
    const unsigned bl = (__ballot_sync(HS_FULL_MASK, blocker) >> sh) & 0xFFFFu;
    const bool sb_ok = ok != 0 && bl == 0;
    if (free_ok && sb_ok) skip = true;  // member chunks leave the main list
    if (live && (t & 15) == 0) {
      sb_flags[t >> 4] = sb_ok;
      sb_bitmap[t >> 4] = sb_ok ? (int)ok : 0;
    }
  }
  if (live) {
    int4* r = reinterpret_cast<int4*>(rows) + 2 * (size_t)id;
    r[0] = make_int4(ci, cj, ck, cls);
    r[1] = make_int4(level, v0, u0, 0);
    flags[id] = !skip;
  } else if (t < n_pad) {
    flags[t] = 0;  // the flag words' tail, read by the popcount of kernel 3
  }
}

// ---------------------------------------------------------------------------
// 3. The stable partition of the rows and the free list.

// The threads before this one in the block whose ``pred`` holds, and the
// block's total (every thread of the block calls it).
__device__ __forceinline__ int cs_block_scan(bool pred, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(HS_FULL_MASK, pred);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = __popc(m & ((1u << lane) - 1u));
  total = 0;
#pragma unroll
  for (int k = 0; k < CS_CMP_THREADS / 32; ++k) {
    const int s = s_warp[k];
    before += k < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return before;
}

// Sum (max) of ``v`` over the block (every thread of the block calls it).
__device__ __forceinline__ int cs_block_reduce(int v, int* s_warp, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const int u = __shfl_xor_sync(HS_FULL_MASK, v, o);
    v = is_max ? max(v, u) : v + u;
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = s_warp[0];
#pragma unroll
  for (int k = 1; k < CS_CMP_THREADS / 32; ++k) r = is_max ? max(r, s_warp[k]) : r + s_warp[k];
  __syncthreads();
  return r;
}

// Free-list entry ``pos``: superblock s's bitmap and (bi, bj, bk).
__device__ __forceinline__ void cs_free_entry(int* fl, int n_sb, int pos, int bitmap, int s,
                                              int nsy, int nzc) {
  fl[pos] = bitmap;
  fl[n_sb + pos] = s / (nsy * nzc);
  fl[2 * n_sb + pos] = (s / nzc) % nsy;
  fl[3 * n_sb + pos] = s % nzc;
}

__global__ void __launch_bounds__(CS_CMP_THREADS)
chunk_compact_kernel(const int* __restrict__ rows, const unsigned char* __restrict__ flags, int n,
                     int n_pad, int n_seg, const unsigned char* __restrict__ sb_flags,
                     const int* __restrict__ sb_bitmap, int n_sb, int nsy, int nzc,
                     int* __restrict__ desc, int* __restrict__ counts, int* __restrict__ fl) {
  __shared__ int s_warp[CS_CMP_THREADS / 32];
  if ((int)blockIdx.x < n_seg) {
    const int lo = blockIdx.x * CS_SEG, hi = min(n, lo + CS_SEG);
    // the flags are 0 / 1 bytes: a word's popcount counts its listed chunks
    const unsigned* words = reinterpret_cast<const unsigned*>(flags);
    int before = 0, total = 0;
    for (int i = threadIdx.x; i < n_pad / 4; i += CS_CMP_THREADS) {
      const int c = __popc(words[i]);
      total += c;
      before += 4 * i < lo ? c : 0;
    }
    before = cs_block_reduce(before, s_warp, false);
    total = cs_block_reduce(total, s_warp, false);
    if (blockIdx.x == 0 && threadIdx.x == 0) counts[0] = total;
    for (int base = lo; base < hi; base += CS_CMP_THREADS) {
      const int id = base + threadIdx.x;
      const bool listed = id < hi && flags[id];
      int tile;
      const int pos = before + cs_block_scan(listed, s_warp, tile);  // listed rows before id
      if (id < hi) {
        const int dst = listed ? pos : total + (id - pos);
        const int4* src = reinterpret_cast<const int4*>(rows) + 2 * (size_t)id;
        int4* out = reinterpret_cast<int4*>(desc) + 2 * (size_t)dst;
        out[0] = src[0];
        out[1] = src[1];
      }
      before += tile;
    }
    return;
  }

  // the free list: listed superblocks in raster order, then the last one again
  int listed = 0, last = -1;
  for (int base = 0; base < n_sb; base += CS_CMP_THREADS) {
    const int s = base + threadIdx.x;
    const bool ok = s < n_sb && sb_flags[s];
    int tile;
    const int pos = listed + cs_block_scan(ok, s_warp, tile);
    if (ok) {
      cs_free_entry(fl, n_sb, pos, sb_bitmap[s], s, nsy, nzc);
      last = s;
    }
    listed += tile;
  }
  last = cs_block_reduce(last, s_warp, true);
  for (int pos = listed + threadIdx.x; pos < n_sb; pos += CS_CMP_THREADS) {
    if (last >= 0) {
      cs_free_entry(fl, n_sb, pos, sb_bitmap[last], last, nsy, nzc);
    } else {
      cs_free_entry(fl, n_sb, pos, 0, 0, nsy, nzc);
    }
  }
  if (threadIdx.x == 0) counts[1] = max(listed, 1);
}

// ---------------------------------------------------------------------------

static size_t cs_align(size_t bytes) { return (bytes + 255) & ~(size_t)255; }
static int cs_pad16(int n) { return (n + 15) & ~15; }

// Byte offsets of one call's scratch regions, and its size.
struct CsScratch {
  size_t hiz, partials, rows, flags, sb_flags, sb_bitmap, bytes;
};

static CsScratch cs_scratch(const CsLevels& L, int n, int n_sb) {
  CsScratch s;
  size_t o = 0;
  s.hiz = o;
  o += cs_align((size_t)3 * L.total * sizeof(float));
  s.partials = o;
  o += cs_align((size_t)4 * L.n_tiles * sizeof(int));
  s.rows = o;
  o += cs_align((size_t)8 * n * sizeof(int));
  s.flags = o;
  o += cs_align((size_t)cs_pad16(n));
  s.sb_flags = o;
  o += cs_align((size_t)n_sb);
  s.sb_bitmap = o;
  o += cs_align((size_t)n_sb * sizeof(int));
  s.bytes = o;
  return s;
}

// out[0]: the scratch bytes of a call on an h x w depth image, n chunks and
// n_sb superblocks (0 without the free split).
extern "C" int hs_chunk_select_scratch(int h, int w, int n, int n_sb, int* out) {
  out[0] = (int)cs_scratch(cs_levels(h, w), n, n_sb).bytes;
  return 0;
}

// depth: (h, w) float32; planes: the (nbx, nby, nzc, 16, 16) planes (field
// 11's flags are read); params: ops/tsdf_stream._stream_params' vector;
// split: 1 for the free split (nbx and nby divisible by 4); v_hi*, u_hi*:
// the band window's origin caps of levels 0-2; scratch: the bytes
// hs_chunk_select_scratch gives. Writes desc (n, 8), counts[0] (listed
// chunks), and with the split counts[1] and fl (4, n / 16): bitmap, bi,
// bj, bk.
extern "C" int hs_chunk_select(const float* depth, int h, int w, const float* planes,
                               const float* params, int nbx, int nby, int nzc, int split,
                               int v_hi0, int v_hi1, int v_hi2, int u_hi0, int u_hi1, int u_hi2,
                               void* scratch, int* desc, int* counts, int* fl, void* stream) {
  const int n = nbx * nby * nzc;
  if (h < 8 || w < 8 || n < 1 || (split && (nbx % 4 || nby % 4))) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const CsLevels L = cs_levels(h, w);
  const int n_sb = split ? n / 16 : 0, n_pad = cs_pad16(n), n_seg = (n + CS_SEG - 1) / CS_SEG;
  const CsScratch s = cs_scratch(L, n, n_sb);
  char* base = static_cast<char*>(scratch);
  float* hiz = reinterpret_cast<float*>(base + s.hiz);
  int* partials = reinterpret_cast<int*>(base + s.partials);
  int* rows = reinterpret_cast<int*>(base + s.rows);
  unsigned char* flags = reinterpret_cast<unsigned char*>(base + s.flags);
  unsigned char* sb_flags = reinterpret_cast<unsigned char*>(base + s.sb_flags);
  int* sb_bitmap = reinterpret_cast<int*>(base + s.sb_bitmap);
  const CsWin win = {{v_hi0, v_hi1, v_hi2, 0}, {u_hi0, u_hi1, u_hi2, 0}};
  chunk_hiz_kernel<<<L.n_tiles, CS_HIZ_THREADS, 0, st>>>(depth, h, w, L, hiz, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_classify_kernel<<<(n + CS_CLS_THREADS - 1) / CS_CLS_THREADS, CS_CLS_THREADS, 0, st>>>(
      params, planes, hiz, partials, L, win, nbx, nby, nzc, split, n_pad, rows, flags, sb_flags,
      sb_bitmap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_compact_kernel<<<n_seg + (split ? 1 : 0), CS_CMP_THREADS, 0, st>>>(
      rows, flags, n, n_pad, n_seg, sb_flags, sb_bitmap, n_sb, nby / 4, nzc, desc, counts, fl);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] hiz, out[1] classify, out[2] compact.
extern "C" int hs_chunk_select_occupancy(int, int* out) {
  int e = hs_occupancy(chunk_hiz_kernel, CS_HIZ_THREADS, 0, out);
  if (!e) e = hs_occupancy(chunk_classify_kernel, CS_CLS_THREADS, 0, out + 1);
  return e ? e : hs_occupancy(chunk_compact_kernel, CS_CMP_THREADS, 0, out + 2);
}
