"""GP log marginal likelihood over value and derivative channels.

Counterpart of ``log_marginal_likelihood`` in
``cornell_moe_tpu/models/likelihood.py``, zero-mean over the raw observation
vector (value + derivative channels, point-major):

    LML = -1/2 y^T K^-1 y - 1/2 log det K - N/2 log 2 pi.

This is the plain path (always the plain covariance matrix, Cholesky and
solves), differentiable, and the oracle of the fused LML kernel
(``ops.kernels.lml_fused``).  The covariance's hyperparameters may carry
batch axes; the result then has those axes.
"""

from __future__ import annotations

import math

import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.covariance import StationaryCovariance
from cornell_moe_tpu_torch.ops import linalg


def log_marginal_likelihood(covariance: StationaryCovariance,
                            noise_variance, points, values,
                            derivatives=(), point_noise=None
                            ) -> torch.Tensor:
    """Zero-mean LML.  ``values`` (n, 1 + m); ``noise_variance`` (..., 1 + m)
    per channel; ``point_noise`` (n, 1 + m) adds per-point noise
    (shape-bucket padding shifts the LML by a theta-independent constant).
    """
    x = torch.as_tensor(points)
    y = torch.as_tensor(values, dtype=x.dtype, device=x.device).reshape(-1)
    c = 1 + len(cov_mod.channels(derivatives))
    k = cov_mod.build_covariance_matrix(covariance, x, derivatives) + \
        torch.diag_embed(cov_mod.noise_diagonal(
            noise_variance, point_noise, covariance.hyperparameters.shape[:-1],
            x.shape[0], c, x))
    chol = linalg.cholesky(k)
    alpha = linalg.cho_solve(chol, y.expand(k.shape[:-1]))
    return (-0.5 * torch.sum(y * alpha, dim=-1)
            - 0.5 * linalg.log_det_from_chol(chol)
            - 0.5 * y.shape[0] * math.log(2.0 * math.pi))
