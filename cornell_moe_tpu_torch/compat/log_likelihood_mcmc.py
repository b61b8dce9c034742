"""MCMC training-object re-export (compat layer).

Counterpart of ``cornell_moe_tpu/compat/log_likelihood_mcmc.py`` (the
reference's ``cpp_wrappers/log_likelihood_mcmc.py``): the class lives in
``cornell_moe_tpu_torch.models.mcmc``; this module provides the reference
import path.
"""

from cornell_moe_tpu_torch.compat.knowledge_gradient_mcmc import \
    GaussianProcessMCMC
from cornell_moe_tpu_torch.models.mcmc import \
    GaussianProcessLogLikelihoodMCMC

__all__ = ["GaussianProcessLogLikelihoodMCMC", "GaussianProcessMCMC"]
