"""GaussianProcess class for the compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/gaussian_process.py`` (the
reference's ``cpp_wrappers/gaussian_process.py``): the same constructor
``(covariance_function, noise_variance, historical_data, derivatives)`` and
method surface; variance matrices are ``(q*(1+m), q*(1+m))`` over (value +
derivative) channels, gradient tensors carry the reduced winner-diagonal
form.  The GP is fitted on the covariance's device in its dtype with no
jitter at any precision, as the JAX class fits it (the float32 jitter
belongs to the ensemble fit, ``models.mcmc.fit_gp_ensemble``).  A failed
factorization raises ``SingularMatrixError``, so the fit reads the host and
runs eagerly; the GP's ``program_cache`` (``ops.programs``) serves the
objectives built on it.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from cornell_moe_tpu_torch.compat._boundary import to_numpy, to_tensor
from cornell_moe_tpu_torch.compat.interfaces import GaussianProcessInterface
from cornell_moe_tpu_torch.exceptions import (SingularMatrixError,
                                              check_finite_cholesky)
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.ops import programs, random_features
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData
from cornell_moe_tpu_torch.utils.rng import as_generator


class GaussianProcess(GaussianProcessInterface):
    """A GP conditioned on HistoricalData (value + derivative channels).
    ``generator`` (a ``torch.Generator`` or a seed; seed 0 when None)
    draws ``sample_point_from_gp`` and ``sample_global_optima``."""

    def __init__(self, covariance_function, noise_variance,
                 historical_data: HistoricalData,
                 derivatives: Sequence[int] = (), generator=None):
        self._covariance = covariance_function
        self.device = covariance_function.device
        self.dtype = covariance_function.dtype
        self._noise_variance = np.asarray(noise_variance, dtype=float)
        self._historical_data = historical_data
        self._derivatives = tuple(int(i) for i in derivatives)
        self._num_derivatives = len(self._derivatives)
        self._generator = as_generator(generator, self.device)
        self.program_cache = programs.ProgramCache()
        self._refit()

    def _tensor(self, array) -> torch.Tensor:
        return to_tensor(array, self.device, self.dtype)

    def _points(self, points_to_sample) -> torch.Tensor:
        return torch.atleast_2d(self._tensor(points_to_sample))

    def _refit(self):
        try:
            self._state = gp_mod.fit_gp(
                self._covariance.to_kernel(),
                self._tensor(self._noise_variance),
                self._tensor(self._historical_data.points_sampled),
                self._tensor(self._historical_data.points_sampled_value),
                derivatives=self._derivatives)
        except torch.linalg.LinAlgError as err:
            raise SingularMatrixError(
                f"GaussianProcess: covariance matrix singular ({err})") \
                from err
        check_finite_cholesky(self._state.chol_K, "GaussianProcess")

    # -- data access ------------------------------------------------------
    @property
    def state(self) -> gp_mod.GaussianProcessState:
        """The underlying functional state."""
        return self._state

    @property
    def dim(self):
        return self._historical_data.dim

    @property
    def num_sampled(self):
        return self._historical_data.num_sampled

    @property
    def num_derivatives(self):
        return self._num_derivatives

    @property
    def derivatives(self):
        return self._derivatives

    @property
    def noise_variance(self):
        return self._noise_variance

    @property
    def _points_sampled(self):
        return self._historical_data.points_sampled

    @property
    def _points_sampled_value(self):
        return self._historical_data.points_sampled_value

    def get_covariance_copy(self):
        return copy.deepcopy(self._covariance)

    def get_historical_data_copy(self):
        return copy.deepcopy(self._historical_data)

    # -- posterior quantities --------------------------------------------
    def compute_mean_of_points(self, points_to_sample):
        return to_numpy(gp_mod.posterior_mean(
            self._state, self._points(points_to_sample)))[:, 0]

    def compute_mean_of_additional_points(self, discrete_pts):
        return self.compute_mean_of_points(discrete_pts)

    def compute_grad_mean_of_points(self, points_to_sample,
                                    num_derivatives=-1):
        pts = self._points(points_to_sample)
        nd = self._clamp_num_derivatives(pts.shape[0], num_derivatives)
        jac = gp_mod.grad_posterior_mean(self._state, pts[:nd],
                                         self._derivatives)
        # reduced form: d mu_i / d x_i only, (num_derivatives, 1+m, dim)
        return to_numpy(torch.stack([jac[i, :, i, :] for i in range(nd)]))

    def compute_variance_of_points(self, points_to_sample):
        return to_numpy(gp_mod.posterior_variance(
            self._state, self._points(points_to_sample), self._derivatives))

    def compute_cholesky_variance_of_points(self, points_to_sample):
        chol = gp_mod.posterior_cholesky_variance(
            self._state, self._points(points_to_sample), self._derivatives)
        return to_numpy(check_finite_cholesky(
            chol, "compute_cholesky_variance_of_points"))

    def compute_grad_variance_of_points(self, points_to_sample,
                                        num_derivatives=-1):
        pts = self._points(points_to_sample)
        nd = self._clamp_num_derivatives(pts.shape[0], num_derivatives)
        jac = gp_mod.grad_posterior_variance(self._state, pts,
                                             self._derivatives)
        # (num_derivatives, q_ch, q_ch, dim)
        return to_numpy(torch.movedim(jac[:, :, :nd, :], 2, 0))

    def compute_grad_cholesky_variance_of_points(self, points_to_sample,
                                                 num_derivatives=-1):
        pts = self._points(points_to_sample)
        nd = self._clamp_num_derivatives(pts.shape[0], num_derivatives)
        jac = gp_mod.grad_posterior_cholesky_variance(
            self._state, pts, self._derivatives)
        return to_numpy(torch.movedim(jac[:, :, :nd, :], 2, 0))

    # -- mutation / sampling ---------------------------------------------
    def add_sampled_points(self, sampled_points):
        self._historical_data.append_sample_points(sampled_points)
        self._refit()

    def sample_point_from_gp(self, point_to_sample, noise_variance=0.0):
        return float(gp_mod.sample_point_from_gp(
            self._generator, self._state, self._tensor(point_to_sample),
            noise_variance=noise_variance))

    def sample_global_optima(self, num_optima, domain_bounds=None,
                             num_grid=500, n_features=1000):
        """Approximate Thompson draws of argmin f (SampleGlobalOptimaFromGP
        counterpart): random-feature samples minimized from a
        Latin-hypercube grid over ``domain_bounds`` (the data's bounding
        box by default)."""
        if domain_bounds is None:
            x = self._historical_data.points_sampled
            domain_bounds = np.stack([x.min(0), x.max(0)], axis=1)
        domain = TensorProductDomain.from_bounds(
            np.asarray(domain_bounds, dtype=float), device=self.device,
            dtype=self.dtype)
        grid = domain.generate_latin_hypercube_points(self._generator,
                                                      num_grid)
        return to_numpy(random_features.sample_from_global_optima(
            self._generator, self._state, domain, grid, num_optima,
            n_features=n_features))

    def print_historical_data(self):
        print(self._historical_data)
