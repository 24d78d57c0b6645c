"""Data layer: build_dataset / build_dataloader (parity: the JAX package's
data/__init__.py). The paired, single-image and Real-ESRGAN OTF datasets
are registered by import (no directory scan); the train loader is the
threaded `DataLoader`, the val/test loader batch 1 in order. A train
dataset with `device_cache: true` still gets its loader (its dataset and
batch size); `train.run` then draws the batches from a `DeviceCacheFeeder`
(data/device_cache.py) instead."""

from __future__ import annotations

from trainner_redux_tpu_torch.data import (  # noqa: F401
    paired_image_dataset,
    realesrgan_dataset,
    single_image_dataset,
)
from trainner_redux_tpu_torch.data.data_sampler import EnlargedSampler, resolve_enlarge_ratio
from trainner_redux_tpu_torch.data.loader import DataLoader, DevicePrefetcher, eval_loader
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY

__all__ = [
    "build_dataset",
    "build_dataloader",
    "DataLoader",
    "DevicePrefetcher",
    "EnlargedSampler",
    "resolve_enlarge_ratio",
]


def build_dataset(dataset_opt: DatasetOptions, seed: int = 0):
    """The dataset of `dataset_opt`; a train dataset draws its crops from
    `seed` (the run's manual_seed)."""
    cls = DATASET_REGISTRY.get(dataset_opt.type)
    if dataset_opt.phase == "train":
        return cls(dataset_opt, seed=seed)
    return cls(dataset_opt)


def build_dataloader(dataset, dataset_opt: DatasetOptions, num_gpu: int = 1,
                     sampler: EnlargedSampler | None = None, seed: int | None = None):
    """Train: batched, sampler order (or a seeded shuffle), drop_last;
    val/test: batch 1, sequential."""
    if dataset_opt.phase != "train":
        return eval_loader(dataset, num_workers=dataset_opt.num_worker_per_gpu or 0)
    if dataset_opt.prefetch_mode not in (None, "cpu", "cuda"):
        raise ValueError(f"prefetch_mode '{dataset_opt.prefetch_mode}' is unknown")
    return DataLoader(
        dataset,
        batch_size=(dataset_opt.batch_size_per_gpu or 4) * max(1, num_gpu),
        sampler=sampler,
        shuffle=sampler is None,
        num_workers=dataset_opt.num_worker_per_gpu or 4,
        drop_last=True,
        prefetch_batches=dataset_opt.num_prefetch_queue or dataset_opt.prefetch_factor or 2,
        seed=seed or 0,
    )
