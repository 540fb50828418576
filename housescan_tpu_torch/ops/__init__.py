"""Kernels of the fusion step and the array code around them.

Each kernel module holds a dispatching wrapper, the kernel's plain
PyTorch version, and a note on the Pallas kernel it replaces:

- ``preprocess_cuda.bilateral_filter_cuda`` (K1, ``csrc/bilateral.cu``)
- ``icp_cuda.icp_level`` (K3, ``csrc/icp.cu``; the 6x6 solve of
  ``solve6.py`` inlined as ``csrc/solve6.cuh``)
- ``solve6.solve_twist_compose`` (K2, ``csrc/solve6.cu``: that solve as
  its own launch, once per iteration of the XLA path's ICP loop)
- ``tsdf_stream.tsdf_integrate_stream`` (K4, ``csrc/tsdf_stream.cu``; the
  plane fit of ``planes.py`` inlined as ``csrc/planes.cuh``; and K5, the
  free carve of the superblock split, ``csrc/tsdf_free.cu``)
- ``raycast_tiles.raycast_tiles_maps`` (K6, ``csrc/raycast_tiles.cu``)
"""
