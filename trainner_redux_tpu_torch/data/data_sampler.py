"""Deterministic index streams (port of the JAX package's
data/data_sampler.py): each rank draws a disjoint shard of a virtually
enlarged, epoch-seeded permutation of the dataset."""

from __future__ import annotations

import numpy as np


class EnlargedSampler:
    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0,
                 ratio: float = 1) -> None:
        self.dataset_len = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(num_samples * ratio / num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self):
        # VIRTUAL indices in [0, dataset_len * ratio): the dataset reads
        # sample index % len and seeds its crop with the virtual index, so
        # each visit of an image within an epoch draws another crop
        g = np.random.default_rng(self.epoch)
        indices = g.permutation(self.total_size)
        indices = indices[self.rank : self.total_size : self.num_replicas]
        return iter(indices.tolist())


def resolve_enlarge_ratio(dataset_enlarge_ratio: str | int, dataset_len: int,
                          threshold: int = 1000) -> int:
    """'auto' enlarges small datasets so one epoch covers >= `threshold` samples."""
    if dataset_enlarge_ratio == "auto":
        return max(1, int(np.ceil(threshold / max(dataset_len, 1))))
    return int(dataset_enlarge_ratio)
