"""Seeds: every stream of random numbers a run uses is derived from the
run's ``--seed`` and a fixed key, so one seed gives the same inputs."""

from __future__ import annotations

import numpy as np


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of run seed ``seed`` (any
    whole number, also past 64 bits)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 128), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *keys))
