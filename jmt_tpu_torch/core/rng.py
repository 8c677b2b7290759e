"""Seeds: the reference's per-epoch reseed contract and per-step streams.

Counterpart of ``jmt_tpu/core/rng.py``. ``set_global_seed`` seeds Python,
numpy and torch (the reference's ``set_seed``; ``MYSEED`` in the
environment as its parseit does). Where the JAX package splits one PRNG
key per train step from ``PRNGKey(SEED + epoch)``, the port derives each
step's seed from (seed, epoch, step) alone (``step_seed``): the step's
colour factors are drawn from a CPU ``torch.Generator`` of that seed, and
torch's default generators (dropout) are seeded with it, so a step draws
the same whether its epoch ran whole or was resumed mid-way, on the card
as on the CPU.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch

SEED_ENV_VAR = "MYSEED"


def set_global_seed(seed: int) -> None:
    """Seed the host RNGs (Python, numpy) and torch's default
    generators."""
    os.environ[SEED_ENV_VAR] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """A 63-bit seed that is a function of (seed, epoch, step) only."""
    words = np.random.SeedSequence([seed, epoch, step]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def step_generator(seed: int, epoch: int, step: int,
                   rank: int = 0) -> torch.Generator:
    """Seed torch's default generators for train step ``step`` of
    ``epoch`` and return a CPU generator of the same seed (the step's
    colour factors). Under a process group the generator is the same on
    every rank (its draws are the global batch's), and ``rank`` > 0
    seeds the default generators (dropout) with a stream of its own, so
    that the ranks' rows do not share their masks."""
    s = step_seed(seed, epoch, step)
    torch.manual_seed(s if rank == 0 else int(
        np.random.SeedSequence([seed, epoch, step, rank]).generate_state(
            1, np.uint64)[0] >> 1))
    return torch.Generator().manual_seed(s)
