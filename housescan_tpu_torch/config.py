"""Configuration dataclasses, a copy of ``housescan_tpu/config.py``.

Every tunable is a named, serialisable dataclass field; ``Config.to_json``
/ ``Config.from_json`` round-trip the same JSON as the reference, so one
config file drives either package. The reference's XLA compilation-cache
helper has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class RoomsConfig:
    """Room-assembly stage tunables."""

    wall_thickness: float = 0.1
    suggestion_cutoff_factor: float = 1.2
    wall_move_step: float = 0.01
    ceiling_fraction: float = 0.2
    face_membership_tol: float = 1e-4
    grid_spacing: float = 6.0


@dataclass(frozen=True)
class CuboidFitConfig:
    """Cuboid fit solver settings."""

    tol: float = 1e-8
    max_iter: int = 2000
    n_starts: int = 8


@dataclass(frozen=True)
class CameraConfig:
    """Depth camera intrinsics: the Kinect/Xtion 640x480 depth camera."""

    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    depth_scale: float = 0.001  # raw uint16 millimeters -> meters
    z_min: float = 0.3
    z_max: float = 6.0

    def scaled(self, level: int) -> "CameraConfig":
        """Intrinsics for pyramid level ``level`` (each level halves),
        point-sampling convention as ``Intrinsics.level``."""
        f = 1 << level
        return dataclasses.replace(
            self,
            width=self.width // f,
            height=self.height // f,
            fx=self.fx / f,
            fy=self.fy / f,
            cx=self.cx / f,
            cy=self.cy / f,
        )


@dataclass(frozen=True)
class TsdfConfig:
    """TSDF volume parameters (PCL KinFu defaults: 3 m cube, 512^3 grid).

    ``dtype`` names a layout for ``kinfu/tsdf.from_config``; as in the
    reference, the scan does not read it (the fusion path picks the
    layout)."""

    resolution: int = 512
    size_m: float = 3.0
    trunc_dist: float = 0.03
    max_weight: float = 128.0
    dtype: str = "float32"

    @property
    def voxel_size(self) -> float:
        return self.size_m / self.resolution


@dataclass(frozen=True)
class IcpConfig:
    """Projective point-to-plane ICP settings."""

    iterations: Tuple[int, ...] = (10, 5, 4)  # per level, finest first
    dist_threshold: float = 0.10  # correspondence rejection (meters)
    angle_threshold: float = 0.5236  # ~30 degrees, normal agreement
    min_valid_fraction: float = 0.1


@dataclass(frozen=True)
class RansacConfig:
    """RANSAC plane detection (the planes.txt producer)."""

    n_hypotheses: int = 512
    inlier_threshold: float = 0.02  # meters
    max_planes: int = 8
    min_inlier_fraction: float = 0.05


@dataclass(frozen=True)
class Config:
    rooms: RoomsConfig = field(default_factory=RoomsConfig)
    cuboid: CuboidFitConfig = field(default_factory=CuboidFitConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)
    icp: IcpConfig = field(default_factory=IcpConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in raw:
                sub = raw[f.name]
                if "iterations" in sub:
                    sub = dict(sub, iterations=tuple(sub["iterations"]))
                kwargs[f.name] = _SUBCONFIGS[f.name](**sub)
        return cls(**kwargs)


_SUBCONFIGS = {
    "rooms": RoomsConfig,
    "cuboid": CuboidFitConfig,
    "camera": CameraConfig,
    "tsdf": TsdfConfig,
    "icp": IcpConfig,
    "ransac": RansacConfig,
}

DEFAULT_CONFIG = Config()
