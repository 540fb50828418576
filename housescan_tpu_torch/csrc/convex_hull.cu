// The scan's plane hulls: Andrew's monotone chain over one plane's
// projected inliers, compiled. It replaces no Pallas kernel and is no
// kernel: the JAX package's hull (housescan_tpu/kinfu/ransac.py
// convex_hull_2d) is a host loop, and so is the port's plain version
// (housescan_tpu_torch/kinfu/ransac.py monotone_chain), which took about
// 0.3-0.4 s of each scan's export in the interpreter. This is the same
// chain as host C++, called once a plane through ctypes
// (ops/convex_hull.py), and it lives in the kernel library only because
// that library is the port's one compiled artefact.
//
// Why host code and not a kernel:
//  - the chain is sequential: each point's pops depend on the stack that
//    the points before it left;
//  - its input is numpy's float64 projection of the inliers onto the
//    plane's basis (kinfu/ransac.py plane_hulls), whose bits the card
//    would not repeat;
//  - the reference's hull is host numpy too, and the hull files must stay
//    byte for byte what the Python chain writes.
//
// Arithmetic: cross2's float64 expression exactly,
// (a0 - o0) * (b1 - o1) - (a1 - o1) * (b0 - o0), each operation rounded
// once, with the same `<= 0` pop test. There must be no FMA and no
// reassociation. nvcc hands this function to the host compiler with -O3
// and no fast-math, so nothing is reassociated; baseline x86-64 has no
// FMA instruction, so the host compiler cannot contract a product into
// the subtraction. The guards below refuse a target where it could (if
// host flags such as -march are ever added, add -ffp-contract=off with
// them) and one that evaluates double in a wider type (x87).
#include <cfloat>

#ifndef __CUDA_ARCH__
#if defined(__FMA__) || defined(__ARM_FEATURE_FMA)
#error "convex_hull.cu: the host target has FMA; build with -Xcompiler -ffp-contract=off"
#endif
#if FLT_EVAL_METHOD != 0
#error "convex_hull.cu: double must evaluate as double (FLT_EVAL_METHOD 0)"
#endif
#endif

static inline double hs_cross2(const double* o, const double* a, const double* b) {
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
}

// One half of the chain over pts[first], pts[first + step], ... (n
// points): the kept indices on `stack`, their number returned.
static long long hs_half(const double* pts, long long n, long long first, long long step,
                         long long* stack) {
    long long k = 0;
    for (long long j = 0, i = first; j < n; ++j, i += step) {
        while (k >= 2 && hs_cross2(pts + 2 * stack[k - 2], pts + 2 * stack[k - 1], pts + 2 * i) <= 0)
            --k;
        stack[k++] = i;
    }
    return k;
}

// pts: n >= 1 unique (x, y) float64 rows sorted by x, then y. Writes the
// row indices of lower[:-1] + upper[:-1], the Python chain's order, to
// `out` (room for 2n - 2) and returns their number; `stack`: room for n.
extern "C" long long hs_convex_hull_2d(const double* pts, long long n, long long* out,
                                       long long* stack) {
    long long m = 0;
    long long k = hs_half(pts, n, 0, 1, stack);
    for (long long j = 0; j + 1 < k; ++j) out[m++] = stack[j];
    k = hs_half(pts, n, n - 1, -1, stack);
    for (long long j = 0; j + 1 < k; ++j) out[m++] = stack[j];
    return m;
}
