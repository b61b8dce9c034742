"""Randomness source container.

Counterpart of ``cornell_moe_tpu/utils/rng.py`` (the reference's
``RandomnessSourceContainer`` binding): one uniform stream plus one normal
stream per "thread", with explicit and time-based seeding and
reset-to-most-recent-seed, the common-random-numbers discipline the MC
estimators rely on.  Each stream is a ``torch.Generator`` on the
container's device: resetting re-seeds it, so the same draws come again.
Normal stream i is seeded with the normal seed + i, as the reference seeds
its per-thread generators.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from cornell_moe_tpu_torch import config


def as_generator(generator, device, default_seed: int = 0
                 ) -> torch.Generator:
    """``generator`` itself when it is a ``torch.Generator``; else a new one
    on ``device`` seeded with ``generator`` (an int) or, when None,
    ``default_seed``."""
    if isinstance(generator, torch.Generator):
        return generator
    seed = default_seed if generator is None else int(generator)
    return torch.Generator(device=device).manual_seed(seed)


def _randomized(base_seed: int) -> int:
    return int(base_seed) ^ int(time.time_ns() & 0x7fffffff)


class RandomnessSourceContainer:
    """Uniform + normal ``torch.Generator`` sources with reference-style
    seeding, on ``device`` (the card unless the caller names one)."""

    def __init__(self, num_normal_rng_streams: int = 1, seed: int = 0,
                 device=None):
        self.device = config.default_device() if device is None \
            else torch.device(device)
        self.num_normal_rng_streams = int(num_normal_rng_streams)
        self.uniform_generator = torch.Generator(device=self.device)
        self.normal_generators = [torch.Generator(device=self.device)
                                  for _ in range(self.num_normal_rng_streams)]
        self.set_explicit_uniform_generator_seed(seed)
        self.set_explicit_normal_rng_seed(seed)

    # -- seed management (binding-name parity) ----------------------------
    def set_explicit_uniform_generator_seed(self, seed: int):
        self._uniform_seed = int(seed)
        self.reset_uniform_generator_seed()

    def set_randomized_uniform_generator_seed(self, base_seed: int = 0):
        self.set_explicit_uniform_generator_seed(_randomized(base_seed))

    def set_explicit_normal_rng_seed(self, seed: int):
        self._normal_seed = int(seed)
        self.reset_normal_rng_seed()

    def set_randomized_normal_rng_seed(self, base_seed: int = 0):
        self.set_explicit_normal_rng_seed(_randomized(base_seed))

    def reset_uniform_generator_seed(self):
        """ResetToMostRecentSeed counterpart (CRN)."""
        self.uniform_generator.manual_seed(self._uniform_seed)

    def reset_normal_rng_seed(self):
        for i, g in enumerate(self.normal_generators):
            g.manual_seed(self._normal_seed + i)

    # -- draws ------------------------------------------------------------
    def _dtype(self, dtype):
        return config.default_dtype(self.device) if dtype is None else dtype

    def uniform(self, shape: Sequence[int],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """U[0, 1) draws from the uniform stream."""
        return torch.rand(tuple(shape), generator=self.uniform_generator,
                          device=self.device, dtype=self._dtype(dtype))

    def normal(self, shape: Sequence[int], stream: int = 0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Standard normal draws from normal stream ``stream``."""
        return torch.randn(tuple(shape),
                           generator=self.normal_generators[stream],
                           device=self.device, dtype=self._dtype(dtype))

    def normals(self, shape: Sequence[int],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One block of draws per normal stream: (num_streams, *shape)."""
        return torch.stack([self.normal(shape, i, dtype)
                            for i in range(self.num_normal_rng_streams)])
