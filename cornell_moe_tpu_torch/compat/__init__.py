"""Reference-API compatibility layer.

Counterpart of ``cornell_moe_tpu/compat/``: the public Python surface of
the reference's ``moe.optimal_learning.python`` package (interfaces +
cpp_wrappers), with the same class names, constructor signatures and
method names, so code written against Cornell-MOE ports with import
changes only.  Everything delegates to the port's functional core
(``cornell_moe_tpu_torch.models`` / ``.acquisition`` / ``.ops``).

Numpy arrays and Python floats cross the class surface; inside, every
object computes on the device and in the dtype of the object it is built
on (a covariance, a domain or a ``GaussianProcessMCMC`` takes ``device``
and ``dtype``: the card and float32 unless the caller names another
device, float64 on the CPU).  Where the JAX classes take ``rng_key``,
these take ``generator``: a ``torch.Generator`` or an int seed.  The JAX
hook ``value_and_grad_jax`` is ``value_and_grad_torch`` here.
"""
