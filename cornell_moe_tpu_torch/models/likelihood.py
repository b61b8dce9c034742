"""GP log marginal likelihood over value and derivative channels, its
gradients and the leave-one-out pseudo-likelihood.

Counterpart of ``cornell_moe_tpu/models/likelihood.py``, zero-mean over the
raw observation vector (value + derivative channels, point-major):

    LML = -1/2 y^T K^-1 y - 1/2 log det K - N/2 log 2 pi.

This is the plain path (always the plain covariance matrix, Cholesky and
solves), differentiable, and the oracle of the fused LML kernel
(``ops.kernels.lml_fused``); :func:`log_marginal_likelihood_tiled` is the
float64 chain's route through the tiled Cholesky on the same K.  The
covariance's hyperparameters may carry batch axes; the LML then has those
axes.  Gradients with respect to the hyperparameters are ``torch.func``
autograd.
"""

from __future__ import annotations

import math

import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.covariance import StationaryCovariance
from cornell_moe_tpu_torch.ops import kernels, linalg
from cornell_moe_tpu_torch.utils import logging_utils


def training_system(covariance: StationaryCovariance, noise_variance,
                    points, values, derivatives, point_noise=None):
    """(y (N,), K (..., N, N)) of the training system over channels: the
    observations point-major and K + diag(noise), a new tensor (the
    float64 chain's tiled Cholesky factors it in place)."""
    x = torch.as_tensor(points)
    y = torch.as_tensor(values, dtype=x.dtype, device=x.device).reshape(-1)
    c = 1 + len(cov_mod.channels(derivatives))
    k = cov_mod.build_covariance_matrix(covariance, x, derivatives) + \
        torch.diag_embed(cov_mod.noise_diagonal(
            noise_variance, point_noise, covariance.hyperparameters.shape[:-1],
            x.shape[0], c, x))
    return y, k


def _system(covariance: StationaryCovariance, noise_variance, points,
            values, derivatives, point_noise=None):
    """(y (N,), chol (..., N, N), K^-1 y (..., N)) of the training system
    K + diag(noise) over channels."""
    y, k = training_system(covariance, noise_variance, points, values,
                           derivatives, point_noise)
    chol = linalg.cholesky(k)
    return y, chol, linalg.cho_solve(chol, y.expand(k.shape[:-1]))


def log_marginal_likelihood(covariance: StationaryCovariance,
                            noise_variance, points, values,
                            derivatives=(), point_noise=None
                            ) -> torch.Tensor:
    """Zero-mean LML.  ``values`` (n, 1 + m); ``noise_variance`` (..., 1 + m)
    per channel; ``point_noise`` (n, 1 + m) adds per-point noise
    (shape-bucket padding shifts the LML by a theta-independent constant).
    Counts ``model.lml_plain`` by the evaluations of the batch, one per
    hyperparameter set; a program replays that growth.
    """
    logging_utils.count("model.lml_plain",
                        covariance.hyperparameters.shape[:-1].numel())
    y, chol, alpha = _system(covariance, noise_variance, points, values,
                             derivatives, point_noise)
    return (-0.5 * torch.sum(y * alpha, dim=-1)
            - 0.5 * linalg.log_det_from_chol(chol)
            - 0.5 * y.shape[0] * math.log(2.0 * math.pi))


def log_marginal_likelihood_tiled(covariance: StationaryCovariance,
                                  noise_variance, points, values,
                                  derivatives=(), point_noise=None
                                  ) -> torch.Tensor:
    """:func:`log_marginal_likelihood` of a batch of W hyperparameter sets
    (W, 1 + dim) through the tiled float64 Cholesky
    (``ops.kernels.lml_chol_f64``), which factors K in place and carries
    the forward solve in its border row: no factor is kept and no
    transposed solve runs.  Not differentiable.  The same K, so it counts
    ``model.lml_plain`` as the plain LML does."""
    logging_utils.count("model.lml_plain",
                        covariance.hyperparameters.shape[:-1].numel())
    y, k = training_system(covariance, noise_variance, points, values,
                           derivatives, point_noise)
    quad, half_logdet = kernels.lml_chol_f64(k, y)
    return (-0.5 * quad - half_logdet
            - 0.5 * y.shape[0] * math.log(2.0 * math.pi))


def grad_log_marginal_likelihood(covariance: StationaryCovariance,
                                 noise_variance, points, values,
                                 derivatives=()) -> torch.Tensor:
    """d LML / d covariance hyperparameters, (1 + dim,), of an unbatched
    kernel."""
    def f(h):
        return log_marginal_likelihood(type(covariance)(hyperparameters=h),
                                       noise_variance, points, values,
                                       derivatives)
    return torch.func.grad(f)(covariance.hyperparameters)


def log_marginal_likelihood_and_all_grads(covariance: StationaryCovariance,
                                          noise_variance, points, values,
                                          derivatives=()):
    """(LML, d LML / d covariance hyperparameters, d LML / d channel noise)
    of an unbatched kernel, in one pass."""
    def f(h, nv):
        return log_marginal_likelihood(type(covariance)(hyperparameters=h),
                                       nv, points, values, derivatives)
    h = covariance.hyperparameters
    nv = torch.as_tensor(noise_variance, dtype=h.dtype, device=h.device)
    (g_h, g_nv), val = torch.func.grad_and_value(f, argnums=(0, 1))(h, nv)
    return val, g_h, g_nv


def leave_one_out_log_likelihood(covariance: StationaryCovariance,
                                 noise_variance, points, values,
                                 derivatives=()) -> torch.Tensor:
    """Leave-one-out log pseudo-likelihood from the Cholesky factor
    (Rasmussen & Williams eqs. 5.10-5.12): with K^-1 from the factor,
    mu_i = y_i - alpha_i / K^-1_ii, s2_i = 1 / K^-1_ii and
    LOO = sum_i log N(y_i | mu_i, s2_i).  Carries the kernel's batch
    axes."""
    y, chol, alpha = _system(covariance, noise_variance, points, values,
                             derivatives)
    eye = torch.eye(y.shape[0], dtype=y.dtype, device=y.device)
    k_inv_diag = torch.diagonal(linalg.cho_solve(chol, eye.expand_as(chol)),
                                dim1=-2, dim2=-1)
    s2 = 1.0 / k_inv_diag
    resid2 = (alpha / k_inv_diag) ** 2
    return torch.sum(-0.5 * torch.log(s2) - 0.5 * resid2 / s2
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def evaluate_log_likelihood_at_hyperparameter_list(
        kernel_name: str, hyperparameter_list, noise_variance, points,
        values, derivatives=()) -> torch.Tensor:
    """The LML at each row of ``hyperparameter_list`` (S, 1 + dim), as one
    batched evaluation over the list's leading axis: (S,)."""
    h = torch.as_tensor(hyperparameter_list)
    return log_marginal_likelihood(
        cov_mod.COVARIANCE_TYPES[kernel_name](hyperparameters=h),
        noise_variance, points, values, derivatives)
