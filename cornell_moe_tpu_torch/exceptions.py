"""Exception hierarchy.

Counterpart of ``cornell_moe_tpu/exceptions.py`` (the reference's
``gpp_exception.{hpp,cpp}`` and its Python translation table): typed
errors for bounds violations, invalid values and singular matrices.  A
failed factorization shows up as NaNs in the port's factors
(``ops.linalg.cholesky``), so the API layer checks results and raises
these.
"""

from __future__ import annotations

import numpy as np
import torch


class OptimalLearningError(Exception):
    """Base error (OptimalLearningException counterpart)."""


class BoundsError(OptimalLearningError):
    """A value fell outside [min, max] (BoundsException<T>)."""

    def __init__(self, message, value=None, min_bound=None, max_bound=None):
        super().__init__(
            f"{message} (value={value}, bounds=[{min_bound}, {max_bound}])")
        self.value, self.min_bound, self.max_bound = value, min_bound, \
            max_bound


class InvalidValueError(OptimalLearningError):
    """A value didn't match what was expected (InvalidValueException<T>)."""

    def __init__(self, message, value=None, truth=None):
        super().__init__(f"{message} (value={value}, expected={truth})")
        self.value, self.truth = value, truth


class SingularMatrixError(OptimalLearningError):
    """Cholesky factorization failed (SingularMatrixException).

    Raised when a covariance factorization produces non-finite entries,
    typically duplicate sampled points with zero noise or extreme
    hyperparameters.
    """

    def __init__(self, message, matrix=None, leading_minor_index=None):
        super().__init__(message)
        self.matrix = matrix
        self.leading_minor_index = leading_minor_index


def check_finite_cholesky(chol, context: str):
    """Raise SingularMatrixError if a factor (tensor or array) has
    non-finite entries; returns ``chol`` otherwise."""
    arr = chol.detach().cpu().numpy() if isinstance(chol, torch.Tensor) \
        else np.asarray(chol)
    if not np.all(np.isfinite(arr)):
        raise SingularMatrixError(
            f"{context}: covariance matrix singular. Check for duplicate "
            f"points (with 0 noise) and/or extreme hyperparameter values.",
            matrix=arr)
    return chol
