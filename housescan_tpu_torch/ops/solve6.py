"""K2: the damped 6x6 solve + twist exponential + pose compose.

Replaces ``housescan_tpu/ops/solve6_pallas.py:_kernel`` (via
``solve_twist_compose``): iterated-Tikhonov null-space filter
x = (A + lam I)^-1 A (A + lam I)^-1 b with lam = max(damping,
null_threshold) * max|diag A| (unrolled Cholesky, the second solve reuses
the factor), a non-finite and >1e3 guard that keeps the pose, a max-step
clamp, Rodrigues via Taylor-series sin/cos (exact in float32 for
|theta| <= 0.3), then pose @ increment.

``solve_twist_math`` is the plain version, on lists of same-shape
tensors. K3 inlines its serial CUDA twin, the device function
``csrc/solve6.cuh``, into its solve block; ``solve_twist_compose``
launches K2 (``csrc/solve6.cu``) standalone, once per Gauss-Newton
iteration of the XLA ICP loop (``kinfu/icp.py``, ``use_pallas=False``).
The reference's sharded path does not call K2: it solves with
``kinfu/icp._solve_increment``.

Why CUDA and one warp: the work is ~700 chained scalar flops on 58
inputs (about 300 bytes moved), so latency bounds it, most of it the
chain's IEEE divisions. One warp reads A, b and the pose where they lie
(three pointers: no concatenation launch), runs the chain on every lane
in the plain version's operation order (``--fmad=false``), computes the
six reciprocals of L's diagonal on six lanes at once and takes each
triangular-solve division from its reciprocal with two FMA corrections,
which gives the correctly rounded quotient: bit-identical to
``solve_twist_plain`` on the card. The result stays on the card: the
host never reads it inside the step.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from housescan_tpu_torch.ops import cuda_lib


def _sin_taylor(t):
    t2 = t * t
    return t * (
        1.0 + t2 * (-1.0 / 6 + t2 * (1.0 / 120 + t2 * (-1.0 / 5040 + t2 / 362880)))
    )


def _cos_taylor(t):
    t2 = t * t
    return 1.0 + t2 * (
        -0.5 + t2 * (1.0 / 24 + t2 * (-1.0 / 720 + t2 * (1.0 / 40320)))
    )


def solve_twist_math(
    a_flat: List[torch.Tensor],
    b_vec: List[torch.Tensor],
    pose_flat: List[torch.Tensor],
    damping,
    max_step,
    null_threshold: float = 1e-2,
) -> List[torch.Tensor]:
    """36 (row-major A), 6 (b) and 16 (pose) float32 tensors of one shape
    -> 16 new pose entries + the post-clamp step norm (0 when the solve
    failed and the pose was kept)."""

    def a(i, j):
        return a_flat[i * 6 + j]

    where = torch.where
    scale = a(0, 0)
    for i in range(1, 6):
        scale = torch.maximum(scale, a(i, i).abs())
    scale = torch.clamp(scale, min=1e-12)
    lam = torch.clamp(damping, min=null_threshold) * scale

    L = [[None] * 6 for _ in range(6)]
    ok = None
    for i in range(6):
        for j in range(i + 1):
            s = a(i, j) + lam if i == j else a(i, j)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                pos = s > 0.0
                ok = pos if ok is None else (ok & pos)
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]

    def chol_solve(rhs):
        y = [None] * 6
        for i in range(6):
            s = rhs[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * 6
        for i in range(5, -1, -1):
            s = y[i]
            for k in range(i + 1, 6):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        return x

    z = chol_solve(b_vec)
    az = [None] * 6
    for i in range(6):
        s = a(i, 0) * z[0]
        for k in range(1, 6):
            s = s + a(i, k) * z[k]
        az[i] = s
    x = chol_solve(az)

    for i in range(6):
        ok = ok & torch.isfinite(x[i])
    x = [where(ok, xi, 0.0) for xi in x]

    nrm2 = x[0] * x[0]
    for i in range(1, 6):
        nrm2 = nrm2 + x[i] * x[i]
    nrm = torch.sqrt(torch.clamp(nrm2, min=1e-24))
    ok = ok & (nrm <= 1e3)
    x = [where(ok, xi, 0.0) for xi in x]
    nrm = where(ok, nrm, 0.0)
    fac = where(nrm > max_step, max_step / nrm, 1.0)
    x = [xi * fac for xi in x]

    wx, wy, wz, tx, ty, tz = x
    theta = torch.sqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=0.0))
    safe_t = torch.clamp(theta, min=1e-12)
    small = theta <= 1e-12
    kx = where(small, 0.0, wx / safe_t)
    ky = where(small, 0.0, wy / safe_t)
    kz = where(small, 0.0, wz / safe_t)
    s = _sin_taylor(theta)
    c = _cos_taylor(theta)
    one_c = 1.0 - c

    r00 = c + one_c * kx * kx
    r01 = s * (-kz) + one_c * kx * ky
    r02 = s * ky + one_c * kx * kz
    r10 = s * kz + one_c * ky * kx
    r11 = c + one_c * ky * ky
    r12 = s * (-kx) + one_c * ky * kz
    r20 = s * (-ky) + one_c * kz * kx
    r21 = s * kx + one_c * kz * ky
    r22 = c + one_c * kz * kz
    zero = torch.zeros_like(r00)
    one = torch.ones_like(r00)
    inc = [
        [r00, r10, r20, zero],
        [r01, r11, r21, zero],
        [r02, r12, r22, zero],
        [tx, ty, tz, one],
    ]

    def p(i, j):
        return pose_flat[i * 4 + j]

    out = []
    for i in range(4):
        for j in range(4):
            s_ = p(i, 0) * inc[0][j]
            for k in range(1, 4):
                s_ = s_ + p(i, k) * inc[k][j]
            out.append(torch.where(ok, s_, p(i, j)))
    out.append(where(ok, nrm * fac, 0.0))
    return out


def solve_twist_plain(pose: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      damping: float = 3e-4, max_step: float = 0.3
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version on any device: (4, 4) pose, (6, 6) A, (6,) b ->
    (new pose (4, 4), post-clamp step norm ())."""
    f32 = torch.float32
    dev = pose.device
    out = solve_twist_math(
        list(a.reshape(36).to(f32)), list(b.reshape(6).to(f32)), list(pose.reshape(16).to(f32)),
        torch.tensor(damping, dtype=f32, device=dev), torch.tensor(max_step, dtype=f32, device=dev),
    )
    return torch.stack(out[:16]).reshape(4, 4), out[16]


def solve_twist_compose(pose: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        damping: float = 3e-4, max_step: float = 0.3
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (pose @ exp(filtered solve of (A, b)), step norm); the norm is
    0 when the solve failed and the pose was kept. CUDA tensors launch
    the kernel (one warp on the current stream, reading A, b and the pose
    in place: a copy is made only of one that is not contiguous float32),
    CPU tensors run ``solve_twist_plain``."""
    if pose.device.type == "cpu":
        cuda_lib.plain_counts["solve6"] += 1
        return solve_twist_plain(pose, a, b, damping, max_step)
    if a.numel() != 36 or b.numel() != 6 or pose.numel() != 16:
        raise ValueError("solve_twist_compose: needs a (6, 6) A, a (6,) b and a (4, 4) pose")
    a, b, pose_in = (t.to(torch.float32).contiguous() for t in (a, b, pose))
    out = torch.empty(17, dtype=torch.float32, device=pose.device)
    cuda_lib.require_cuda("solve_twist_compose", a, b, pose_in, out)
    cuda_lib.launch("hs_solve6", pose.device, a.data_ptr(), b.data_ptr(), pose_in.data_ptr(),
                    out.data_ptr(), float(damping), float(max_step))
    cuda_lib.launch_counts["solve6"] += 1
    return out[:16].reshape(4, 4), out[16]
