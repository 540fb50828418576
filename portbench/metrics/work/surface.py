"""The surface extraction's work for one scan: one read of the volume.

The zero-crossing test needs every voxel's tsdf and weight once (8
bytes a voxel of the float32 (2, R, R, R) volume); what it writes, the
surface points, is at most ``max_points_full`` x 12 bytes, under a
thousandth of that at the configurations' sizes, and is left out. The
sign comparisons are not float operations: none are counted, so the
bytes bind.
"""

from __future__ import annotations


def volume_work(resolution: int):
    """(bytes, ops) of one read of a cubic float32 volume."""
    return 2 * resolution ** 3 * 4, 0
