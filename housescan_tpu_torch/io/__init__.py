"""Host-side file formats: .pcd clouds, .ply meshes, planes.txt and .xf
transforms (numpy copies of ``housescan_tpu/io``, byte-compatible with
its writers)."""

import numpy as np
import torch


def host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
