"""K1: the bilateral depth filter.

Replaces ``housescan_tpu/ops/preprocess_pallas.py:_kernel`` (via
``bilateral_filter_pallas``), an edge-preserving filter over a
(2r+1)^2 window: Gaussian-in-space times biweight-in-range weights,
0 = invalid depth, taps outside the image weigh 0.

CUDA kernel ``csrc/bilateral.cu``. At 640x480 and radius 3 it reads and
writes 1.2 MB each and does ~10 float operations a tap, 15 M taps: its
bound by operations is 0.002 ms, but the kernel builds with
``--fmad=false`` (every multiply and add issues alone), so what holds it
is instruction issue: the radius-3 kernel has ~15 instructions a tap
and pixel (2,984 a thread in its static SASS), so an estimate of its
issue floor is 7.2 M warp instructions, 0.0069 ms at four a clock on
each of 132 SMs at 1,980 MHz (``chip_smoke.py``'s estimate: the static
count, the staging loop counted once).

Design: a block of 32 x 4 threads owns a 128 x 4 tile of the output and
stages it with an r-pixel halo in shared memory, 0 outside the image, so
the taps need no bounds compares and no global loads. Each thread
computes 4 adjacent pixels of a row, loading each tap row's 4 + 2r
values once with 16-byte shared loads and reusing them from registers.
The radius is a template parameter (0..7): the taps unroll and each
spatial weight is read at a compile-time index of the by-value
parameter (the constant bank). The weights are computed once per launch
on the host with ``exp`` in double precision and rounded to float32, as
``math.exp`` is in the reference. Each pixel runs this module's plain
float32 operations in their order (dy outer, dx inner; tap * wr, then
* wr; the two sums; one division), so the kernel is bit-identical to
``bilateral_filter_plain``.

CUDA C++ rather than Triton: the per-radius template gives every tap its
weight as a compile-time constant of a fully unrolled loop, and the
16-byte register reuse of a tap row is written by hand; the library
builds with ``--fmad=false``, which the kernel's bit-identity needs.
"""

from __future__ import annotations

import math

import torch

from housescan_tpu_torch.ops import cuda_lib


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-filled shift: position p holds img[p - (dy, dx)]."""
    h, w = img.shape
    out = torch.zeros_like(img)
    if abs(dy) >= h or abs(dx) >= w:  # shifted wholly outside the image
        return out
    out[max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)] = img[
        max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)
    ]
    return out


def bilateral_filter_plain(
    depth: torch.Tensor,
    radius: int = 3,
    sigma_space: float = 4.5,
    sigma_depth: float = 0.03,
) -> torch.Tensor:
    """K1's plain version: ``(H, W)`` meters, 0 = invalid.

    The range weight is the biweight (1 - (dd/3 sigma)^2)_+^2; the spatial
    Gaussian is a constant per tap."""
    valid = depth > 0
    inv_2ss = 0.5 / (sigma_space * sigma_space)
    inv_9sd2 = 1.0 / (9.0 * sigma_depth * sigma_depth)
    weight_sum = torch.zeros_like(depth)
    value_sum = torch.zeros_like(depth)
    zero = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = _shift2d(depth, dy, dx)
            ok = (shifted > 0) & valid
            dd = shifted - depth
            wr = torch.clamp(1.0 - dd * dd * inv_9sd2, min=0.0)
            w = math.exp(-(dy * dy + dx * dx) * inv_2ss) * wr * wr
            w = torch.where(ok, w, zero)
            weight_sum = weight_sum + w
            value_sum = value_sum + w * shifted
    out = torch.where(
        weight_sum > 0, value_sum / torch.clamp(weight_sum, min=1e-12), zero
    )
    return torch.where(valid, out, zero)


def bilateral_filter_cuda(
    depth: torch.Tensor,
    radius: int = 3,
    sigma_space: float = 4.5,
    sigma_depth: float = 0.03,
) -> torch.Tensor:
    """K1: the plain version for a CPU tensor, the CUDA kernel otherwise."""
    if depth.device.type == "cpu":
        cuda_lib.plain_counts["bilateral"] += 1
        return bilateral_filter_plain(depth, radius, sigma_space, sigma_depth)
    cuda_lib.require_cuda("bilateral_filter_cuda", depth)
    if depth.dim() != 2 or not 0 <= radius <= 7:
        raise ValueError("bilateral_filter_cuda: (H, W) depth and radius <= 7")
    h, w = depth.shape
    out = torch.empty_like(depth)
    cuda_lib.launch(
        "hs_bilateral", depth.device,
        depth.data_ptr(), out.data_ptr(), h, w, radius,
        sigma_space, sigma_depth,
    )
    cuda_lib.launch_counts["bilateral"] += 1
    return out
