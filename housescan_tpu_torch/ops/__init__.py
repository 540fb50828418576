"""Kernels of the fusion step and the array code around them.

Each kernel module holds a dispatching wrapper, the kernel's plain
PyTorch version, and a note on the Pallas kernel it replaces:

- ``preprocess_cuda.bilateral_filter_cuda`` (K1, ``csrc/bilateral.cu``)
- ``pyramid_cuda.pyramid_cuda`` (K11, ``csrc/pyramid.cu``: the tracker's
  coarser depths and live maps after K1, which the reference computes as
  XLA array code, not a Pallas kernel)
- ``icp_cuda.icp_level`` (K3, ``csrc/icp.cu``; the 6x6 solve of
  ``solve6.py`` inlined as ``csrc/solve6.cuh``)
- ``solve6.solve_twist_compose`` (K2, ``csrc/solve6.cu``: that solve as
  its own launch, once per iteration of the XLA path's ICP loop)
- ``tsdf_stream.tsdf_integrate_stream`` (K4, ``csrc/tsdf_stream.cu``; the
  plane fit of ``planes.py`` inlined as ``csrc/planes.cuh``; and K5, the
  free carve of the superblock split, ``csrc/tsdf_free.cu``)
- ``raycast_tiles.raycast_tiles_maps`` (K6, ``csrc/raycast_tiles.cu``)
- ``planes_cuda.extract_subblock_planes`` (K7, ``csrc/planes_extract.cu``:
  the planes of every chunk, for ``raycast_planes.raycast_pallas``)
- ``tsdf_cuda.tsdf_integrate_with_planes`` / ``tsdf_integrate_pallas``
  (K8, ``csrc/tsdf_dense.cu``: the dense column integrate with its fused
  plane fit)
- ``chunk_select.launch_chunk_select`` (K9, ``csrc/chunk_select.cu``: the
  work lists of ``tsdf_stream``'s integrate, which the reference computes
  as XLA array code, not a Pallas kernel)
- ``marching_tets.launch_marching_tets`` (K10, ``csrc/marching_tets.cu``:
  the scan's marching-tetrahedra mesh, ``kinfu/marching_cubes``' CUDA
  path; XLA array code in the reference too)

``tsdf_integrate_pallas`` is exported here, as the reference exports it.
"""

# The kinfu package re-exports the step, which imports these modules, and
# these modules import kinfu's: importing kinfu first lets any module of
# this package be the first one imported.
import housescan_tpu_torch.kinfu  # noqa: E402,F401

__all__ = ["tsdf_integrate_pallas"]


def __getattr__(name):
    # Resolved on first use: ``kinfu.tsdf`` imports ``ops.cuda_lib``, so an
    # eager import of ``tsdf_cuda`` here would import ``kinfu.tsdf`` while
    # it is still initialising.
    if name == "tsdf_integrate_pallas":
        from housescan_tpu_torch.ops.tsdf_cuda import tsdf_integrate_pallas

        return tsdf_integrate_pallas
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
