"""Parallel fusion and fitting over a single-controller device mesh
(``parallel/mesh.py``): the X-slab sharded fusion step, rooms fitted and
re-fused side by side."""

from housescan_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from housescan_tpu_torch.parallel.sharded import (
    ShardedKinFuState,
    make_sharded_step,
    sharded_fusion_step,
    sharded_kinfu_init,
)
from housescan_tpu_torch.parallel.rooms_batch import fit_cuboids_sharded
from housescan_tpu_torch.parallel.refuse import refuse_rooms_2d

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "ShardedKinFuState",
    "sharded_fusion_step",
    "sharded_kinfu_init",
    "fit_cuboids_sharded",
    "refuse_rooms_2d",
]
