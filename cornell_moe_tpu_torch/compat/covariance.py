"""Covariance containers for the compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/covariance.py`` (the reference's
``cpp_wrappers/covariance.py``): hyperparameter containers with the
CovarianceInterface surface.  Unlike the reference, where the Python
``SquareExponential`` is a label and the C++ builds Matérn-5/2, each class
maps to the kernel it names.  A container computes, and builds its kernel
(:meth:`to_kernel`), on its ``device`` in its ``dtype``.
"""

from __future__ import annotations

import numpy as np

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.compat._boundary import to_numpy, to_tensor
from cornell_moe_tpu_torch.compat.interfaces import CovarianceInterface
from cornell_moe_tpu_torch.models import covariance as cov_mod


class _CovarianceCompat(CovarianceInterface):

    _kernel_name = None
    covariance_type = None

    def __init__(self, hyperparameters, device=None, dtype=None):
        self._hyperparameters = np.asarray(hyperparameters, dtype=float)
        self.device, self.dtype = config.placement(device, dtype)

    @property
    def num_hyperparameters(self):
        return self.to_kernel().num_hyperparameters

    def get_hyperparameters(self):
        return np.copy(self._hyperparameters)

    def set_hyperparameters(self, hyperparameters):
        self._hyperparameters = np.asarray(hyperparameters, dtype=float)

    hyperparameters = property(get_hyperparameters, set_hyperparameters)

    def to_kernel(self, hyperparameters=None) -> cov_mod.StationaryCovariance:
        """The port's kernel object, with the container's hyperparameters
        or the given ones (a tensor, which may carry batch axes and
        autograd)."""
        if hyperparameters is None:
            hyperparameters = to_tensor(self._hyperparameters, self.device,
                                        self.dtype)
        return cov_mod.COVARIANCE_TYPES[self._kernel_name](
            hyperparameters=hyperparameters)

    def _pair(self, point_one, point_two):
        return (to_tensor(point_one, self.device, self.dtype),
                to_tensor(point_two, self.device, self.dtype))

    def covariance(self, point_one, point_two):
        return float(self.to_kernel().covariance(
            *self._pair(point_one, point_two)))

    def grad_covariance(self, point_one, point_two):
        return to_numpy(self.to_kernel().grad_covariance(
            *self._pair(point_one, point_two)))

    def hyperparameter_grad_covariance(self, point_one, point_two):
        return to_numpy(self.to_kernel().hyperparameter_grad_covariance(
            *self._pair(point_one, point_two)))


class SquareExponential(_CovarianceCompat):
    _kernel_name = "square_exponential"
    covariance_type = "square_exponential"


class MaternNu2p5(_CovarianceCompat):
    _kernel_name = "matern_2.5"
    covariance_type = "matern_2.5"


COVARIANCE_TYPES_TO_CLASSES = {
    "square_exponential": SquareExponential,
    "matern_2.5": MaternNu2p5,
}
