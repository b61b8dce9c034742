"""PyTorch + CUDA port of the Bayesian-optimization core (H100 target).

The JAX package ``cornell_moe_tpu`` is the reference this port is held
against; the layout mirrors it (``models/``, ``acquisition/``, ``ops/``,
``utils/``, ``bayes_opt.py``, ``config.py``) so each counterpart sits under
the same path.  This package imports ``torch`` and numpy only.

Importing it turns TF32 off for matmuls and cuDNN: the GP posterior algebra
is cancellation-sensitive, and TF32 keeps about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config"]
