"""Real-ESRGAN on-the-fly (OTF) datasets: GT crops and per-sample random
blur kernels (port of the JAX package's data/realesrgan_dataset.py).

`RealESRGANDataset` loads GT only: the host flip/rotate augment, then a pad
or random crop to gt_size + 32 (the margin absorbs the blur halos before the
final crop on the device), kept uint8; and kernel1, kernel2 and sinc_kernel
(21x21 fp32) per sample. Every draw comes from `worker_rng(seed, 1, index,
epoch)` in the JAX package's order, so a sample is the JAX one bit for bit.
The degradations run on the device, in `models/realesrgan_model.py`.
`RealESRGANPairedDataset` adds a paired LR/HR sample for
`RealESRGANPairedModel`.
"""

from __future__ import annotations

import numpy as np

from trainner_redux_tpu_torch.data.data_util import paths_from_folder
from trainner_redux_tpu_torch.data.degradation_kernels import (
    circular_lowpass_kernel,
    random_mixed_kernels,
)
from trainner_redux_tpu_torch.data.transforms import augment
from trainner_redux_tpu_torch.utils.file_client import FileClient
from trainner_redux_tpu_torch.utils.img_util import imfrombytes
from trainner_redux_tpu_torch.utils.redux_options import DatasetOptions
from trainner_redux_tpu_torch.utils.registry import DATASET_REGISTRY
from trainner_redux_tpu_torch.utils.rng import worker_rng


@DATASET_REGISTRY.register()
class RealESRGANDataset:
    def __init__(self, opt: DatasetOptions, seed: int = 0) -> None:
        self.opt = opt
        self.seed = seed
        io = dict(opt.io_backend or {"type": "disk"})
        backend = io.pop("type", "disk")
        if backend != "disk":
            raise NotImplementedError(f"io_backend '{backend}' is not ported to torch yet")
        if opt.gt_size is None:
            raise ValueError("RealESRGANDataset requires gt_size")
        self.file_client = FileClient("disk")
        gt_folders = opt.dataroot_gt or []
        if isinstance(gt_folders, str):
            gt_folders = [gt_folders]
        self.paths = [p for folder in gt_folders for p in paths_from_folder(folder)]
        if opt.meta_info:
            import os.path as osp

            with open(opt.meta_info, encoding="utf-8") as f:
                listed = [line.strip().split(" ")[0] for line in f if line.strip()]
            self.paths = [osp.join(gt_folders[0], p) for p in listed]

        # 21x21 pulse (identity) kernel, used when the final sinc is skipped
        self.pulse_kernel = np.zeros((21, 21), np.float32)
        self.pulse_kernel[10, 10] = 1.0
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.paths)

    def _sample_kernel(self, rng: np.random.Generator, order: int) -> np.ndarray:
        opt = self.opt
        if order == 1:
            krange = opt.kernel_range
            sinc_prob, klist, kprob = opt.sinc_prob, opt.kernel_list, opt.kernel_prob
            sigma, betag, betap = opt.blur_sigma, opt.betag_range, opt.betap_range
        else:
            krange = opt.kernel_range2
            sinc_prob, klist, kprob = opt.sinc_prob2, opt.kernel_list2, opt.kernel_prob2
            sigma, betag, betap = opt.blur_sigma2, opt.betag_range2, opt.betap_range2
        kernel_size = int(rng.choice(np.arange(krange[0], krange[1] + 1, 2)))
        if rng.uniform() < sinc_prob:
            omega_lo = np.pi / 3 if kernel_size < 13 else np.pi / 5
            kernel = circular_lowpass_kernel(rng.uniform(omega_lo, np.pi), kernel_size)
        else:
            kernel = random_mixed_kernels(
                rng, klist, kprob, kernel_size, sigma, sigma,
                (-np.pi, np.pi), betag, betap, noise_range=None,
            )
        pad = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        opt = self.opt
        # `index` may be virtual (EnlargedSampler): the sample is index % len,
        # the generator is seeded by the virtual index
        rng = worker_rng(self.seed, 1, index, self._epoch)
        gt_path = self.paths[index % len(self.paths)]
        # uint8 through augment and crop; normalised on the device
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=False)
        img_gt = augment([img_gt], opt.use_hflip, opt.use_rot, rng=rng)[0]

        crop_pad_size = opt.gt_size + 32
        h, w = img_gt.shape[:2]
        if h < crop_pad_size or w < crop_pad_size:
            img_gt = np.pad(
                img_gt,
                ((0, max(0, crop_pad_size - h)), (0, max(0, crop_pad_size - w)), (0, 0)),
            )
            h, w = img_gt.shape[:2]
        if h > crop_pad_size or w > crop_pad_size:
            top = int(rng.integers(0, h - crop_pad_size + 1))
            left = int(rng.integers(0, w - crop_pad_size + 1))
            img_gt = img_gt[top : top + crop_pad_size, left : left + crop_pad_size]

        kernel1 = self._sample_kernel(rng, 1)
        kernel2 = self._sample_kernel(rng, 2)
        if rng.uniform() < opt.final_sinc_prob:
            kernel_size = int(rng.choice(np.arange(opt.final_kernel_range[0],
                                                   opt.final_kernel_range[1] + 1, 2)))
            sinc_kernel = circular_lowpass_kernel(rng.uniform(np.pi / 3, np.pi), kernel_size,
                                                  pad_to=21)
        else:
            sinc_kernel = self.pulse_kernel
        return {
            "gt": np.ascontiguousarray(img_gt),
            "kernel1": kernel1,
            "kernel2": kernel2,
            "sinc_kernel": sinc_kernel,
            "gt_path": gt_path,
        }


@DATASET_REGISTRY.register()
class RealESRGANPairedDataset:
    """OTF samples (GT and kernels) together with paired LR/HR samples, for
    mixed training (`RealESRGANPairedModel`)."""

    def __init__(self, opt: DatasetOptions, seed: int = 0) -> None:
        from trainner_redux_tpu_torch.data.paired_image_dataset import PairedImageDataset

        self.opt = opt
        self.otf = RealESRGANDataset(opt, seed=seed)
        self.paired = PairedImageDataset(opt, seed=seed) if opt.dataroot_lq else None

    def set_epoch(self, epoch: int) -> None:
        self.otf.set_epoch(epoch)
        if self.paired:
            self.paired.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.otf)

    def __getitem__(self, index: int) -> dict:
        out = self.otf[index]
        if self.paired:
            paired = self.paired[index % len(self.paired)]
            out.update({"paired_lq": paired["lq"], "paired_gt": paired["gt"]})
        return out
