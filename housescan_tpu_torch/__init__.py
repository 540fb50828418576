"""housescan_tpu_torch: the KinFu fusion step and the scan path (depth
stream to room directory) in PyTorch with hand-written Hopper (sm_90a)
CUDA kernels.

A port of ``housescan_tpu`` (JAX/Pallas). The layout mirrors it module for
module (``geometry/``, ``kinfu/``, ``ops/``) and keeps its data layouts at
every public function: channel-major (8, H, W) model maps and (6, H, W)
live maps, the 19-row ICP packing, the int16-in-int32 packed and the
float32 (2, X, Y, Z) TSDF volumes, the persistent (R/8, R/8, R/128, 16, 16) sub-block planes, and row-vector
4x4 poses (``pose[3, :3]`` is the translation).

Kernels (``ops/``) dispatch on the device of their input: a CPU tensor
runs the kernel's plain PyTorch version, a CUDA tensor launches the CUDA
kernel built from ``csrc/`` (``ops/cuda_lib.py``) or raises.

This package imports neither ``jax`` nor ``housescan_tpu``.
"""

__version__ = "0.1.0"

from housescan_tpu_torch import geometry, solvers, utils  # noqa: E402,F401
