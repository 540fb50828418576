"""K1: the bilateral depth filter.

Replaces ``housescan_tpu/ops/preprocess_pallas.py:_kernel`` (via
``bilateral_filter_pallas``), an edge-preserving filter over a
(2r+1)^2 window: Gaussian-in-space times biweight-in-range weights,
0 = invalid depth, taps outside the image weigh 0.

CUDA kernel ``csrc/bilateral.cu``: one thread per pixel, 49 taps read
through the L1/texture path. At 640x480 it reads 49 x 1.2 MB (mostly
L1/L2 hits) and writes 1.2 MB; it is bound by the ~10 float ops per tap,
about 15 MFLOP a frame, far below the card's rate, so a launch is a few
microseconds of latency. The spatial weights are computed once per
launch on the host with ``exp`` in double precision and rounded to
float32, as ``math.exp`` is in the reference, and reach the kernel in its
parameter space.
"""

from __future__ import annotations

import math

import torch

from housescan_tpu_torch.ops import cuda_lib


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-filled shift: position p holds img[p - (dy, dx)]."""
    h, w = img.shape
    out = torch.zeros_like(img)
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
    lib = cuda_lib.load()
    rc = lib.hs_bilateral(
        depth.data_ptr(), out.data_ptr(), h, w, radius,
        sigma_space, sigma_depth, cuda_lib.stream_ptr(),
    )
    cuda_lib.check(rc, "hs_bilateral")
    cuda_lib.launch_counts["bilateral"] += 1
    return out
