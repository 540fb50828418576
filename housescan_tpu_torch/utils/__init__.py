"""Host helpers (bijections, connected components) and order statistics."""

from housescan_tpu_torch.utils.bijection import biject, ord_nub
from housescan_tpu_torch.utils.graph import group_connected_components
from housescan_tpu_torch.utils.vector_util import kth_largest_by, kth_smallest_by

__all__ = [
    "biject",
    "ord_nub",
    "group_connected_components",
    "kth_largest_by",
    "kth_smallest_by",
]
