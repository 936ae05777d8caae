"""Seeding — python, numpy and torch (replaces [recbole] init_seed)."""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int, reproducibility: bool = True) -> torch.Generator:
    """Seed the python/numpy/torch globals and return a CPU
    ``torch.Generator`` seeded with ``seed``.

    Device randomness in the port is drawn from explicit generators
    (the counterpart of the JAX package's root PRNG key).  The port's
    kernels are deterministic (no atomics), so ``reproducibility``
    exists for config parity with the reference only.
    """
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen
