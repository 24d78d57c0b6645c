"""Host-side randomness of the data pipeline (port of `worker_rng` in the
JAX package's utils/rng.py): one numpy Generator per (seed, rank, worker or
sample, epoch), so crops and augments are deterministic and independent of
thread scheduling. Device-side randomness (DropPath) uses an explicit
torch.Generator that the model owns."""

from __future__ import annotations

import numpy as np


def worker_rng(seed: int, rank: int, worker_id: int, epoch: int = 0) -> np.random.Generator:
    """Independent generator, deterministic across restarts."""
    return np.random.default_rng([seed, rank, worker_id, epoch])
