"""Paired LR/HR image dataset (parity: the JAX package's
data/paired_image_dataset.py).

Train phase: uint8 HWC crops of `lq_size` (and `scale` times that for GT),
cut and flipped by a generator drawn from `worker_rng(seed, 0, index,
epoch)`, so a sample depends only on the seed, its (virtual) index and the
epoch; decoded images are kept in RAM (`cache_decoded`, by default for up
to 2000 files) and the crops are views into them. Evaluation phases:
mod-cropped full images as float32 HWC numpy arrays.
"""

from __future__ import annotations

import numpy as np

from trainner_redux_tpu_torch.data.data_util import (
    paired_paths_from_folders,
    paired_paths_from_meta_info_file,
)
from trainner_redux_tpu_torch.data.transforms import augment, mod_crop, paired_random_crop
from trainner_redux_tpu_torch.utils.file_client import FileClient
from trainner_redux_tpu_torch.utils.img_util import imfrombytes
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY
from trainner_redux_tpu_torch.utils.rng import worker_rng


@DATASET_REGISTRY.register()
class PairedImageDataset:
    def __init__(self, opt: DatasetOptions, seed: int = 0) -> None:
        self.opt = opt
        self.seed = seed
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

        self._epoch = 0
        cache_opt = opt.cache_decoded
        self._cache_enabled = opt.phase == "train" and (
            len(self.paths) <= 2000 if cache_opt is None else bool(cache_opt)
        )
        self._cache: dict[str, np.ndarray] = {}

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.paths)

    def _load_u8(self, path: str) -> np.ndarray:
        """Decoded uint8 image, RAM-cached when enabled. Worker threads may
        decode one path twice; both results are equal."""
        img = self._cache.get(path) if self._cache_enabled else None
        if img is None:
            img = imfrombytes(self.file_client.get(path), float32=False)
            if self._cache_enabled:
                self._cache[path] = img
        return img

    def __getitem__(self, index: int) -> dict:
        opt = self.opt
        scale = opt.scale or 1
        # `index` may be virtual (EnlargedSampler yields [0, len * ratio))
        entry = self.paths[index % len(self.paths)]

        if opt.phase == "train":
            if opt.color or opt.mean is not None or opt.std is not None:
                raise NotImplementedError(
                    "color / mean / std of a train dataset are not ported to torch yet"
                )
            lq_size = opt.lq_size or ((opt.gt_size // scale) if opt.gt_size else None)
            if lq_size is None:
                raise ValueError("the train phase requires lq_size (or gt_size)")
            rng = worker_rng(self.seed, 0, index, self._epoch)
            img_gt, img_lq = paired_random_crop(
                self._load_u8(entry["gt_path"]), self._load_u8(entry["lq_path"]), lq_size, scale,
                rng,
            )
            img_gt, img_lq = augment([img_gt, img_lq], opt.use_hflip, opt.use_rot, rng=rng)
            return {"lq": img_lq, "gt": img_gt, "lq_path": entry["lq_path"],
                    "gt_path": entry["gt_path"]}

        img_gt = imfrombytes(self.file_client.get(entry["gt_path"]), float32=True)
        img_lq = imfrombytes(self.file_client.get(entry["lq_path"]), float32=True)
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
