"""Data layer of the serving path: build_dataset / build_dataloader.

Parity: the JAX package's data/__init__.py. Only the two evaluation datasets
are registered here (imported by name, no directory scan); the training
datasets and loaders come with the training path.
"""

from __future__ import annotations

from trainner_redux_tpu_torch.data import paired_image_dataset, single_image_dataset  # noqa: F401
from trainner_redux_tpu_torch.data.loader import eval_loader
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY

__all__ = ["build_dataset", "build_dataloader"]


def build_dataset(dataset_opt: DatasetOptions):
    return DATASET_REGISTRY.get(dataset_opt.type)(dataset_opt)


def build_dataloader(dataset, dataset_opt: DatasetOptions):
    """The val/test loader: batch 1, sequential."""
    if dataset_opt.phase == "train":
        raise NotImplementedError("the training loader is not ported to torch yet")
    return eval_loader(dataset, num_workers=dataset_opt.num_worker_per_gpu or 0)
