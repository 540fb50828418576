"""Geometry: rigid transforms (row-vector convention), plane algebra,
plane fitting and plane-triple corners."""

from housescan_tpu_torch.geometry.fitting import fit_plane, plane_corner, plane_corners_batch
from housescan_tpu_torch.geometry.plane import (
    PlaneEq,
    flip_plane_eq,
    mk_plane_eq,
    mk_plane_eq_abcd,
    project_to_plane,
    signed_distance_to_plane,
)
from housescan_tpu_torch.geometry.transform import (
    apply_proj4,
    axis_angle_mat,
    compose_proj4,
    identity_proj4,
    proj4_from_rot,
    proj4_from_translation,
    quat_rot_mat,
    rotate_around,
    rotation_between_normals,
    rotation_proj4_around,
)

__all__ = [
    "PlaneEq",
    "mk_plane_eq",
    "mk_plane_eq_abcd",
    "flip_plane_eq",
    "signed_distance_to_plane",
    "project_to_plane",
    "fit_plane",
    "plane_corner",
    "plane_corners_batch",
    "apply_proj4",
    "axis_angle_mat",
    "compose_proj4",
    "identity_proj4",
    "proj4_from_rot",
    "proj4_from_translation",
    "quat_rot_mat",
    "rotate_around",
    "rotation_between_normals",
    "rotation_proj4_around",
]
