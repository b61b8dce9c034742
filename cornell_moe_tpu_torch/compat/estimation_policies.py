"""Batch estimation policies (compat layer).

Counterpart of ``cornell_moe_tpu/compat/estimation_policies.py``: the
ConstantLiarEstimationPolicy / KrigingBelieverEstimationPolicy classes the
reference exports from its bindings, consumed by
heuristic_expected_improvement_optimization.  Each is callable on a core
state and a point tensor, as the core's heuristic q-EI calls its policy.
"""

from __future__ import annotations

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import expected_improvement as ei_core
from cornell_moe_tpu_torch.compat._boundary import to_tensor
from cornell_moe_tpu_torch.utils.constant import (
    CONSTANT_LIAR_MAX, CONSTANT_LIAR_MEAN, CONSTANT_LIAR_MIN,
    DEFAULT_CONSTANT_LIAR_LIE_NOISE_VARIANCE,
    DEFAULT_KRIGING_NOISE_VARIANCE, DEFAULT_KRIGING_STD_DEVIATION_COEF)


def _state_and_point(gaussian_process, point):
    """The core state of a compat GP (a core state passes through) and the
    point as a tensor on its device."""
    state = getattr(gaussian_process, "state", gaussian_process)
    if not isinstance(point, torch.Tensor):
        x = state.points_sampled
        point = to_tensor(point, x.device, x.dtype)
    return state, point


class ConstantLiarEstimationPolicy:
    """Fantasize a constant value for in-flight points."""

    def __init__(self, lie_value,
                 lie_noise_variance=DEFAULT_CONSTANT_LIAR_LIE_NOISE_VARIANCE):
        self.lie_value = float(lie_value)
        self.lie_noise_variance = float(lie_noise_variance)

    @classmethod
    def from_method(cls, method, values,
                    lie_noise_variance=
                    DEFAULT_CONSTANT_LIAR_LIE_NOISE_VARIANCE):
        """Build from the CL_MIN/CL_MAX/CL_MEAN method strings."""
        values = np.asarray(values)
        lie = {CONSTANT_LIAR_MIN: values.min(),
               CONSTANT_LIAR_MAX: values.max(),
               CONSTANT_LIAR_MEAN: values.mean()}[method]
        return cls(lie, lie_noise_variance)

    def compute_estimate(self, gaussian_process, point):
        return self(*_state_and_point(gaussian_process, point))

    def __call__(self, state, point):
        return ei_core.constant_liar_estimate(
            state, point, self.lie_value, self.lie_noise_variance)


class KrigingBelieverEstimationPolicy:
    """Fantasize mu(x) + c * sigma(x) for in-flight points."""

    def __init__(self,
                 std_deviation_coef=DEFAULT_KRIGING_STD_DEVIATION_COEF,
                 kriging_noise_variance=DEFAULT_KRIGING_NOISE_VARIANCE):
        self.std_deviation_coef = float(std_deviation_coef)
        self.kriging_noise_variance = float(kriging_noise_variance)

    def compute_estimate(self, gaussian_process, point):
        return self(*_state_and_point(gaussian_process, point))

    def __call__(self, state, point):
        return ei_core.kriging_believer_estimate(
            state, point, self.std_deviation_coef,
            self.kriging_noise_variance)
