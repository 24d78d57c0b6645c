"""Paired LR/HR image dataset, evaluation phases (parity: the JAX package's
data/paired_image_dataset.py).

Produces mod-cropped full images as float32 HWC numpy arrays. The training
phase (random crops, augmentation, the decoded-image cache) comes with the
training data path.
"""

from __future__ import annotations

import numpy as np

from trainner_redux_tpu_torch.data.data_util import (
    paired_paths_from_folders,
    paired_paths_from_meta_info_file,
)
from trainner_redux_tpu_torch.data.transforms import mod_crop
from trainner_redux_tpu_torch.utils.file_client import FileClient
from trainner_redux_tpu_torch.utils.img_util import imfrombytes
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class PairedImageDataset:
    def __init__(self, opt: DatasetOptions) -> None:
        self.opt = opt
        if opt.phase == "train":
            raise NotImplementedError("the training phase is not ported to torch yet")
        io = dict(opt.io_backend or {"type": "disk"})
        backend = io.pop("type", "disk")
        if backend != "disk":
            raise NotImplementedError(f"io_backend '{backend}' is not ported to torch yet")
        self.file_client = FileClient("disk")

        gt_folders = opt.dataroot_gt or []
        lq_folders = opt.dataroot_lq or []
        if isinstance(gt_folders, str):
            gt_folders = [gt_folders]
        if isinstance(lq_folders, str):
            lq_folders = [lq_folders]
        filename_tmpl = opt.filename_tmpl or "{}"
        if opt.meta_info:
            self.paths = paired_paths_from_meta_info_file(
                (lq_folders, gt_folders), ("lq", "gt"), opt.meta_info, filename_tmpl
            )
        else:
            self.paths = paired_paths_from_folders(
                (lq_folders, gt_folders), ("lq", "gt"), filename_tmpl
            )

    def __len__(self) -> int:
        return len(self.paths)

    def _load(self, path: str) -> np.ndarray:
        return imfrombytes(self.file_client.get(path), float32=True)

    def __getitem__(self, index: int) -> dict:
        opt = self.opt
        scale = opt.scale or 1
        entry = self.paths[index]
        img_gt = self._load(entry["gt_path"])
        img_lq = self._load(entry["lq_path"])
        # mod-crop GT so shapes divide the scale exactly
        img_gt = mod_crop(img_gt, scale)
        h, w = img_lq.shape[0], img_lq.shape[1]
        img_gt = img_gt[: h * scale, : w * scale, ...]

        if opt.color == "y":
            from trainner_redux_tpu_torch.utils.color_util import rgb2ycbcr_np

            img_gt = rgb2ycbcr_np(img_gt, y_only=True)[..., None]
            img_lq = rgb2ycbcr_np(img_lq, y_only=True)[..., None]

        if opt.mean is not None or opt.std is not None:
            mean = np.asarray(opt.mean or [0.0] * img_gt.shape[-1], np.float32)
            std = np.asarray(opt.std or [1.0] * img_gt.shape[-1], np.float32)
            img_gt = (img_gt - mean) / std
            img_lq = (img_lq - mean) / std

        return {
            "lq": np.ascontiguousarray(img_lq, dtype=np.float32),
            "gt": np.ascontiguousarray(img_gt, dtype=np.float32),
            "lq_path": entry["lq_path"],
            "gt_path": entry["gt_path"],
        }
