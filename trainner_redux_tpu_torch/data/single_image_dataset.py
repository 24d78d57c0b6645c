"""LQ-only inference dataset (parity: the JAX package's data/single_image_dataset.py)."""

from __future__ import annotations

import numpy as np

from trainner_redux_tpu_torch.data.data_util import paths_from_folder
from trainner_redux_tpu_torch.utils.file_client import FileClient
from trainner_redux_tpu_torch.utils.img_util import imfrombytes
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SingleImageDataset:
    def __init__(self, opt: DatasetOptions) -> None:
        self.opt = opt
        io = dict(opt.io_backend or {"type": "disk"})
        backend = io.pop("type", "disk")
        if backend != "disk":
            raise NotImplementedError(f"io_backend '{backend}' is not ported to torch yet")
        self.file_client = FileClient("disk")
        self.paths = []
        for p in opt.dataroot_lq or []:
            self.paths.extend(paths_from_folder(p))

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict:
        path = self.paths[index]
        img_lq = imfrombytes(self.file_client.get(path), float32=True)
        if self.opt.mean is not None or self.opt.std is not None:
            mean = np.asarray(self.opt.mean or [0.0] * img_lq.shape[-1], np.float32)
            std = np.asarray(self.opt.std or [1.0] * img_lq.shape[-1], np.float32)
            img_lq = (img_lq - mean) / std
        return {"lq": np.ascontiguousarray(img_lq, dtype=np.float32), "lq_path": path}
