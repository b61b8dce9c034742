"""Default configuration parameters.

Counterpart of ``cornell_moe_tpu/utils/constant.py`` (the reference's
``python/constant.py``): named default optimizer parameter packs, MC
iteration counts, covariance/domain/optimizer type strings, and
constant-liar/kriging constants, built on the port's own parameter classes
(``ops.optimizers``).  The thread-count knobs are kept for API parity and
are advisory only: parallelism is the batch axes of one device program.
"""

from __future__ import annotations

from collections import namedtuple

from cornell_moe_tpu_torch.ops.optimizers import (GradientDescentParameters,
                                                  NewtonParameters)

# Thread knobs (advisory)
DEFAULT_MAX_NUM_THREADS = 4
MAX_ALLOWED_NUM_THREADS = 10000

# Covariance types
SQUARE_EXPONENTIAL_COVARIANCE_TYPE = "square_exponential"
MATERN_25_COVARIANCE_TYPE = "matern_2.5"
COVARIANCE_TYPES = [SQUARE_EXPONENTIAL_COVARIANCE_TYPE,
                    MATERN_25_COVARIANCE_TYPE]

GaussianProcessParameters = namedtuple(
    "GaussianProcessParameters", ["length_scale", "signal_variance"])
DEFAULT_GAUSSIAN_PROCESS_PARAMETERS = GaussianProcessParameters(
    length_scale=[0.2], signal_variance=1.0)

# Domain types
TENSOR_PRODUCT_DOMAIN_TYPE = "tensor_product"
SIMPLEX_INTERSECT_TENSOR_PRODUCT_DOMAIN_TYPE = \
    "simplex_intersect_tensor_product"
DOMAIN_TYPES = [TENSOR_PRODUCT_DOMAIN_TYPE,
                SIMPLEX_INTERSECT_TENSOR_PRODUCT_DOMAIN_TYPE]

# Optimizer types
NULL_OPTIMIZER = "null_optimizer"
NEWTON_OPTIMIZER = "newton_optimizer"
GRADIENT_DESCENT_OPTIMIZER = "gradient_descent_optimizer"
L_BFGS_B_OPTIMIZER = "l_bfgs_b_optimizer"
OPTIMIZER_TYPES = [NULL_OPTIMIZER, NEWTON_OPTIMIZER,
                   GRADIENT_DESCENT_OPTIMIZER, L_BFGS_B_OPTIMIZER]

# Likelihood types
LEAVE_ONE_OUT_LOG_LIKELIHOOD = "leave_one_out_log_likelihood"
LOG_MARGINAL_LIKELIHOOD = "log_marginal_likelihood"
LIKELIHOOD_TYPES = [LEAVE_ONE_OUT_LOG_LIKELIHOOD, LOG_MARGINAL_LIKELIHOOD]

# MC iteration counts
DEFAULT_EXPECTED_IMPROVEMENT_MC_ITERATIONS = 10000
DEFAULT_KNOWLEDGE_GRADIENT_MC_ITERATIONS = 2**7
DEFAULT_QEI_SEED_MC_ITERATIONS = 2**10
TEST_EXPECTED_IMPROVEMENT_MC_ITERATIONS = 50
TEST_OPTIMIZER_MULTISTARTS = 3
TEST_OPTIMIZER_NUM_RANDOM_SAMPLES = 3

TEST_GRADIENT_DESCENT_PARAMETERS = GradientDescentParameters(
    num_multistarts=TEST_OPTIMIZER_MULTISTARTS, max_num_steps=5,
    max_num_restarts=2, num_steps_averaged=1, gamma=0.4, pre_mult=1.0,
    max_relative_change=1.0, tolerance=1.0e-3)

# Model selection defaults
DEFAULT_NULL_NUM_RANDOM_SAMPLES_MODEL_SELECTION = 300000
DEFAULT_GRADIENT_DESCENT_MULTISTARTS_MODEL_SELECTION = 400
DEFAULT_GRADIENT_DESCENT_NUM_RANDOM_SAMPLES_MODEL_SELECTION = 0
DEFAULT_GRADIENT_DESCENT_PARAMETERS_MODEL_SELECTION = \
    GradientDescentParameters(
        num_multistarts=DEFAULT_GRADIENT_DESCENT_MULTISTARTS_MODEL_SELECTION,
        max_num_steps=600, max_num_restarts=10, num_steps_averaged=0,
        gamma=0.9, pre_mult=0.25, max_relative_change=0.2,
        tolerance=1.0e-5)
DEFAULT_NEWTON_PARAMETERS_MODEL_SELECTION = NewtonParameters(
    num_multistarts=200, max_num_steps=100, gamma=1.05,
    time_factor=1.0e-2, max_relative_change=1.0, tolerance=1.0e-9)

# Analytic EI defaults
DEFAULT_NULL_NUM_RANDOM_SAMPLES_EI_ANALYTIC = 500000
DEFAULT_GRADIENT_DESCENT_MULTISTARTS_EI_ANALYTIC = 600
DEFAULT_GRADIENT_DESCENT_NUM_RANDOM_SAMPLES_EI_ANALYTIC = 50000
DEFAULT_GRADIENT_DESCENT_PARAMETERS_EI_ANALYTIC = GradientDescentParameters(
    num_multistarts=DEFAULT_GRADIENT_DESCENT_MULTISTARTS_EI_ANALYTIC,
    max_num_steps=500, max_num_restarts=4, num_steps_averaged=0,
    gamma=0.6, pre_mult=1.0, max_relative_change=1.0, tolerance=1.0e-7)

# MC EI defaults
DEFAULT_NULL_NUM_RANDOM_SAMPLES_EI_MC = 50000
DEFAULT_GRADIENT_DESCENT_MULTISTARTS_EI_MC = 200
DEFAULT_GRADIENT_DESCENT_NUM_RANDOM_SAMPLES_EI_MC = 4000
DEFAULT_GRADIENT_DESCENT_PARAMETERS_EI_MC = GradientDescentParameters(
    num_multistarts=DEFAULT_GRADIENT_DESCENT_MULTISTARTS_EI_MC,
    max_num_steps=500, max_num_restarts=4, num_steps_averaged=100,
    gamma=0.6, pre_mult=1.0, max_relative_change=1.0, tolerance=1.0e-5)

DefaultOptimizerInfoTuple = namedtuple(
    "DefaultOptimizerInfoTuple",
    ["num_multistarts", "num_random_samples", "optimizer_parameters"])

# EI compute / batch-policy constants
EI_COMPUTE_TYPE_ANALYTIC = "ei_analytic"
EI_COMPUTE_TYPE_MONTE_CARLO = "ei_monte_carlo"
SINGLE_POINT_EI = "single_point_ei"
MULTI_POINT_EI = "multi_point_ei"
CONSTANT_LIAR_MIN = "constant_liar_min"
CONSTANT_LIAR_MAX = "constant_liar_max"
CONSTANT_LIAR_MEAN = "constant_liar_mean"
CONSTANT_LIAR_METHODS = [CONSTANT_LIAR_MIN, CONSTANT_LIAR_MAX,
                         CONSTANT_LIAR_MEAN]
DEFAULT_CONSTANT_LIAR_METHOD = CONSTANT_LIAR_MAX
DEFAULT_CONSTANT_LIAR_LIE_NOISE_VARIANCE = 1e-12
DEFAULT_KRIGING_NOISE_VARIANCE = 1e-8
DEFAULT_KRIGING_STD_DEVIATION_COEF = 0.0

# Latin-hypercube "dumb search" size of the reference's main program
DEFAULT_LHC_SEARCH_ITERATIONS = 20000
