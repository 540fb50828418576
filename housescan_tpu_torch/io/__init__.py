"""Host-side file formats: .pcd clouds, .ply meshes, planes.txt and .xf
transforms (numpy copies of ``housescan_tpu/io``, byte-compatible with
its writers), scene checkpoints and the native host helpers."""

import numpy as np
import torch


def host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


from housescan_tpu_torch.io.pcd import load_pcd, save_pcd  # noqa: E402
from housescan_tpu_torch.io.planes_txt import load_planes_txt, save_planes_txt  # noqa: E402
from housescan_tpu_torch.io.ply import load_ply, save_ply  # noqa: E402
from housescan_tpu_torch.io.xf import load_xf, save_xf  # noqa: E402

__all__ = [
    "host",
    "load_pcd",
    "save_pcd",
    "load_planes_txt",
    "save_planes_txt",
    "load_ply",
    "save_ply",
    "load_xf",
    "save_xf",
]
