"""Abstract interfaces for the compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/interfaces.py`` (the reference's
``python/interfaces/*.py``, one module here instead of six):
GaussianProcessInterface, CovarianceInterface, DomainInterface,
OptimizableInterface, OptimizerInterface, ExpectedImprovementInterface,
GaussianProcessLogLikelihoodInterface, with the same abstract methods and
properties.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class GaussianProcessDataInterface(ABC):
    """Core data access (gaussian_process_interface.py:19)."""

    @abstractmethod
    def get_covariance_copy(self):
        ...

    @abstractmethod
    def get_historical_data_copy(self):
        ...

    def get_core_data_copy(self):
        return self.get_covariance_copy(), self.get_historical_data_copy()


class GaussianProcessInterface(GaussianProcessDataInterface):
    """Posterior access (gaussian_process_interface.py:64)."""

    @property
    @abstractmethod
    def dim(self):
        ...

    @property
    @abstractmethod
    def num_sampled(self):
        ...

    @staticmethod
    def _clamp_num_derivatives(num_points, num_derivatives):
        if num_derivatives < 0 or num_derivatives > num_points:
            return num_points
        return num_derivatives

    @abstractmethod
    def compute_mean_of_points(self, points_to_sample):
        ...

    @abstractmethod
    def compute_grad_mean_of_points(self, points_to_sample,
                                    num_derivatives):
        ...

    @abstractmethod
    def compute_variance_of_points(self, points_to_sample):
        ...

    @abstractmethod
    def compute_cholesky_variance_of_points(self, points_to_sample):
        ...

    @abstractmethod
    def compute_grad_variance_of_points(self, points_to_sample,
                                        num_derivatives):
        ...

    @abstractmethod
    def compute_grad_cholesky_variance_of_points(self, points_to_sample,
                                                 num_derivatives):
        ...

    @abstractmethod
    def add_sampled_points(self, sampled_points):
        ...

    @abstractmethod
    def sample_point_from_gp(self, point_to_sample, noise_variance=0.0):
        ...


class CovarianceInterface(ABC):
    """covariance_interface.py counterpart."""

    @property
    @abstractmethod
    def num_hyperparameters(self):
        ...

    @abstractmethod
    def get_hyperparameters(self):
        ...

    @abstractmethod
    def set_hyperparameters(self, hyperparameters):
        ...

    @abstractmethod
    def covariance(self, point_one, point_two):
        ...

    @abstractmethod
    def grad_covariance(self, point_one, point_two):
        ...

    @abstractmethod
    def hyperparameter_grad_covariance(self, point_one, point_two):
        ...


class DomainInterface(ABC):
    """domain_interface.py counterpart."""

    @property
    @abstractmethod
    def dim(self):
        ...

    @abstractmethod
    def check_point_inside(self, point):
        ...

    @abstractmethod
    def generate_uniform_random_points_in_domain(self, num_points,
                                                 random_source=None):
        ...

    @abstractmethod
    def compute_update_restricted_to_domain(self, max_relative_change,
                                            current_point, update_vector):
        ...


class OptimizableInterface(ABC):
    """optimization_interface.py counterpart: an objective with state."""

    @property
    @abstractmethod
    def problem_size(self):
        ...

    @abstractmethod
    def get_current_point(self):
        ...

    @abstractmethod
    def set_current_point(self, current_point):
        ...

    current_point = property(
        lambda self: self.get_current_point(),
        lambda self, p: self.set_current_point(p))

    @abstractmethod
    def compute_objective_function(self):
        ...

    @abstractmethod
    def compute_grad_objective_function(self):
        ...

    def compute_hessian_objective_function(self):
        raise NotImplementedError


class OptimizerInterface(ABC):
    """optimization_interface.py: optimize() mutates objective state."""

    @abstractmethod
    def optimize(self, **kwargs):
        ...


class ExpectedImprovementInterface(OptimizableInterface):
    """expected_improvement_interface.py counterpart."""

    @abstractmethod
    def compute_expected_improvement(self, **kwargs):
        ...

    @abstractmethod
    def compute_grad_expected_improvement(self, **kwargs):
        ...


class GaussianProcessLogLikelihoodInterface(ABC):
    """log_likelihood_interface.py counterpart."""

    @property
    @abstractmethod
    def num_hyperparameters(self):
        ...

    @abstractmethod
    def get_hyperparameters(self):
        ...

    @abstractmethod
    def set_hyperparameters(self, hyperparameters):
        ...

    @abstractmethod
    def compute_log_likelihood(self):
        ...

    @abstractmethod
    def compute_grad_log_likelihood(self):
        ...
