"""The benchmark of ``cornell_moe_tpu_torch``: closed-loop Bayesian
optimization iterations on one card, driven by the data files beside this
module (``configs/``, ``traffic/``, ``metrics/``, ``limits/``).

Run one cell from the root of a checkout::

    python3 -m cmoe_bench.run --workload qkg-branin.refit --seed 1 \
        --seconds 10 --trace 0

Nothing here imports ``jax`` or the JAX package, and ``reference/``
imports nothing of the port either.
"""
