"""The device-memory dataset cache: decoded uint8 LR/HR images held on the
card, each training batch cut there (port of the JAX package's
data/device_cache.py, `device_cache: true` on a train dataset).

Conv-speed networks step faster than a host loader decodes, crops and
copies; with the cache, the steady state copies nothing from the host. Each
batch: B image indices drawn with replacement, a uniform crop offset in
each image's valid range (the HR window at x scale of the LR one), and the
same three dihedral coin flips as the host loader's augment (hflip, vflip,
transpose, as `use_hflip` / `use_rot` allow), all on the card from an
explicit `torch.Generator` there, seeded from the run's `manual_seed`. The
stream is not the JAX package's, and the host loader visits each image once
an epoch where the cache samples with replacement.

Capacity: every image is zero-padded to the largest and stacked, so the
cache holds N * max_h * max_w * 3 * (1 + scale^2) bytes. Above
TRAINNER_DEVICE_CACHE_MB (default 6144) it raises, as the JAX package's
does; it does not fall back to the host loader.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def device_cache_eligible(dataset, opt) -> tuple[bool, str]:
    """Whether `dataset` can be served from the cache (the JAX package's
    check): train-phase data with raw uint8 access, no mean / std / colour
    conversion."""
    if getattr(opt, "phase", None) != "train":
        return False, "device_cache: only the train phase is supported"
    if opt.mean is not None or opt.std is not None or opt.color:
        return False, "device_cache: mean/std/color-y need the host path"
    if not hasattr(dataset, "paths") or not hasattr(dataset, "_load_u8"):
        return False, f"device_cache: {type(dataset).__name__} has no raw access"
    return True, ""


class DeviceCacheFeeder:
    """In place of the DevicePrefetcher (`reset`, `next`, `close`): `next()`
    returns {"lq", "gt"}, uint8 NHWC batches cut on `device`, and never
    ends an epoch (the iteration count bounds the loop). `batches_cut`
    counts the batches it cut."""

    def __init__(self, dataset, opt, batch_size: int, device, seed: int = 0) -> None:
        ok, why = device_cache_eligible(dataset, opt)
        if not ok:
            raise ValueError(why)
        scale = opt.scale or 1
        lq_size = opt.lq_size or (opt.gt_size // scale if opt.gt_size else None)
        if lq_size is None:
            raise ValueError("device_cache: the train phase requires gt_size or lq_size")
        self.batch_size, self.lq_size, self.scale = batch_size, int(lq_size), int(scale)
        self.use_hflip, self.use_rot = bool(opt.use_hflip), bool(opt.use_rot)
        self.device = torch.device(device)
        self.batches_cut = 0

        lqs, gts = [], []
        for entry in dataset.paths:
            lq = dataset._load_u8(entry["lq_path"])
            lqs.append(lq)
            gts.append(dataset._load_u8(entry["gt_path"])[: lq.shape[0] * scale,
                                                           : lq.shape[1] * scale])
        dims = np.asarray([lq.shape[:2] for lq in lqs], np.int64)
        if (dims < self.lq_size).any():
            raise ValueError(f"device_cache: an LR image is smaller than lq_size {self.lq_size}")
        hm, wm = dims.max(axis=0)
        n = len(lqs)
        budget = float(os.environ.get("TRAINNER_DEVICE_CACHE_MB", 6144)) * 2**20
        total = n * hm * wm * 3 * (1 + scale * scale)
        if total > budget:
            raise ValueError(f"device_cache: {total / 2**20:.0f} MB exceeds "
                             f"TRAINNER_DEVICE_CACHE_MB={budget / 2**20:.0f}")
        lq_store = np.zeros((n, hm, wm, 3), np.uint8)
        gt_store = np.zeros((n, hm * scale, wm * scale, 3), np.uint8)
        for i, (lq, gt) in enumerate(zip(lqs, gts)):
            lq_store[i, : lq.shape[0], : lq.shape[1]] = lq
            gt_store[i, : gt.shape[0], : gt.shape[1]] = gt
        self._lq = torch.from_numpy(lq_store).to(self.device)
        self._gt = torch.from_numpy(gt_store).to(self.device)
        self._dims = torch.from_numpy(dims).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def reset(self) -> None:
        """Nothing: sampling with replacement has no epoch state."""

    def close(self) -> None:
        """Nothing to stop: the cache runs no thread."""

    def _crop(self, store: torch.Tensor, idx, y0, x0, size: int) -> torch.Tensor:
        ar = torch.arange(size, device=self.device)
        rows = (y0[:, None] + ar)[:, :, None]
        cols = (x0[:, None] + ar)[:, None, :]
        return store[idx[:, None, None], rows, cols]

    def _d4(self, img: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
        """The host augment's hflip, vflip and transpose where `bits` say."""
        flags = bits.view(-1, 3, 1, 1, 1)
        if self.use_hflip:
            img = torch.where(flags[:, 0], img.flip(2), img)
        if self.use_rot:
            img = torch.where(flags[:, 1], img.flip(1), img)
            img = torch.where(flags[:, 2], img.transpose(1, 2), img)
        return img

    def next(self) -> dict[str, Any]:
        b, size, g = self.batch_size, self.lq_size, self.generator
        idx = torch.randint(0, self._lq.shape[0], (b,), generator=g, device=self.device)
        span = self._dims[idx] - size + 1  # (b, 2) valid offsets
        u = torch.rand((b, 2), generator=g, device=self.device)
        off = torch.minimum(torch.floor(u * span).long(), span - 1)
        bits = torch.rand((b, 3), generator=g, device=self.device) < 0.5
        lq = self._crop(self._lq, idx, off[:, 0], off[:, 1], size)
        s = self.scale
        gt = self._crop(self._gt, idx, off[:, 0] * s, off[:, 1] * s, size * s)
        self.batches_cut += 1
        return {"lq": self._d4(lq, bits), "gt": self._d4(gt, bits)}
