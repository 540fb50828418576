"""Solvers on the device: batched Nelder-Mead, the cuboid fit and the
1-D positioning least squares."""

from housescan_tpu_torch.solvers.cuboid_fit import (
    cuboid_from_params,
    errfun,
    errfun_closest,
    fit_cuboid,
    fit_cuboid_batch,
    fit_cuboid_from_center,
    fit_cuboid_from_center_first,
    guess_dims,
)
from housescan_tpu_torch.solvers.nelder_mead import nelder_mead
from housescan_tpu_torch.solvers.translation_optimizer import lst_sq_distances, lst_sq_distances_dense

__all__ = [
    "cuboid_from_params",
    "errfun",
    "errfun_closest",
    "fit_cuboid",
    "fit_cuboid_batch",
    "fit_cuboid_from_center",
    "fit_cuboid_from_center_first",
    "guess_dims",
    "nelder_mead",
    "lst_sq_distances",
    "lst_sq_distances_dense",
]
