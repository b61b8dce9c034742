"""Small compatibility utilities: linkers, comparison, timing, cpp_utils.

Counterpart of ``cornell_moe_tpu/compat/misc.py`` (the reference's
``python/linkers.py``, ``python/comparison.py``, ``python/timing.py`` and
``cpp_wrappers/cpp_utils.py``).  The cppify/uncppify pair is a reshape
here (there is no Python->C++ marshaling boundary), kept so ported code
keeps working.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import namedtuple

import numpy as np
import torch

# --- cpp_utils.py counterparts --------------------------------------------


def cppify(array):
    """Flatten to a contiguous 1-d float array (cpp_utils.py:6)."""
    return np.ascontiguousarray(np.asarray(array, dtype=float)).ravel()


def uncppify(array, expected_shape):
    """Reshape a flat array back (cpp_utils.py:34)."""
    return np.asarray(array, dtype=float).reshape(expected_shape)


def cppify_hyperparameters(hyperparameters):
    """[alpha, lengths...] passthrough (cpp_utils.py:41)."""
    return cppify(hyperparameters)


# --- comparison.py counterpart --------------------------------------------

class EqualityComparisonMixin:
    """Value-equality via __dict__ comparison (comparison.py);
    arrays and tensors compare element by element."""

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        mine, theirs = self.__dict__, other.__dict__
        if mine.keys() != theirs.keys():
            return False
        for k in mine:
            a, b = mine[k], theirs[k]
            if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
                if not (isinstance(a, torch.Tensor) and
                        isinstance(b, torch.Tensor) and torch.equal(a, b)):
                    return False
            elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    return False
            elif a != b:
                return False
        return True

    def __ne__(self, other):
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    __hash__ = None


# --- timing.py counterpart ------------------------------------------------

@contextlib.contextmanager
def timing_context(name, logger=None):
    """Log the wall-clock duration of a block (timing.py:14)."""
    log = logger or logging.getLogger(__name__)
    start = time.time()
    try:
        yield
    finally:
        log.info("%s took %f seconds", name, time.time() - start)


# --- linkers.py counterpart -----------------------------------------------

CovarianceLinks = namedtuple("CovarianceLinks", ["python_covariance_class"])
DomainLinks = namedtuple("DomainLinks", ["python_domain_class"])
LogLikelihoodMethod = namedtuple(
    "LogLikelihoodMethod", ["log_likelihood_type", "log_likelihood_class"])


def _build_linkers():
    from cornell_moe_tpu_torch.compat import covariance as cov_c
    from cornell_moe_tpu_torch.compat import domain as dom_c
    from cornell_moe_tpu_torch.compat import log_likelihood as lik_c
    from cornell_moe_tpu_torch.utils import constant as const

    covariance_links = {
        const.SQUARE_EXPONENTIAL_COVARIANCE_TYPE:
            CovarianceLinks(cov_c.SquareExponential),
        const.MATERN_25_COVARIANCE_TYPE:
            CovarianceLinks(cov_c.MaternNu2p5),
    }
    domain_links = {
        const.TENSOR_PRODUCT_DOMAIN_TYPE:
            DomainLinks(dom_c.TensorProductDomain),
        const.SIMPLEX_INTERSECT_TENSOR_PRODUCT_DOMAIN_TYPE:
            DomainLinks(dom_c.SimplexIntersectTensorProductDomain),
    }
    log_likelihood_links = {
        const.LOG_MARGINAL_LIKELIHOOD: LogLikelihoodMethod(
            const.LOG_MARGINAL_LIKELIHOOD,
            lik_c.GaussianProcessLogMarginalLikelihood),
        const.LEAVE_ONE_OUT_LOG_LIKELIHOOD: LogLikelihoodMethod(
            const.LEAVE_ONE_OUT_LOG_LIKELIHOOD,
            lik_c.GaussianProcessLeaveOneOutLogLikelihood),
    }
    return covariance_links, domain_links, log_likelihood_links


COVARIANCE_TYPES_TO_CLASSES, DOMAIN_TYPES_TO_CLASSES, \
    LOG_LIKELIHOOD_TYPES_TO_CLASSES = _build_linkers()
