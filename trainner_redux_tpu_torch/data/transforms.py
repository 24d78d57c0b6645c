"""Host-side transforms (numpy, HWC): mod crop, the paired random crop and
the flip/rotate augment (port of the JAX package's data/transforms.py).
Every draw comes from the Generator passed in, in the JAX package's order,
so the same generator gives the same crops and flips."""

from __future__ import annotations

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]


def paired_random_crop(img_gt: np.ndarray, img_lq: np.ndarray, lq_patch_size: int, scale: int,
                       rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Crop matching (lq_patch, scale * lq_patch) windows from an LQ/GT pair."""
    h_lq, w_lq = img_lq.shape[0], img_lq.shape[1]
    h_gt, w_gt = img_gt.shape[0], img_gt.shape[1]
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x of LQ ({h_lq}, {w_lq})."
        )
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(
            f"LQ ({h_lq}, {w_lq}) is smaller than patch size ({lq_patch_size}, {lq_patch_size})."
        )
    top = int(rng.integers(0, h_lq - lq_patch_size + 1))
    left = int(rng.integers(0, w_lq - lq_patch_size + 1))
    lq = img_lq[top : top + lq_patch_size, left : left + lq_patch_size, ...]
    gt_patch = lq_patch_size * scale
    gt = img_gt[top * scale : top * scale + gt_patch, left * scale : left * scale + gt_patch, ...]
    return gt, lq


def augment(imgs: list[np.ndarray], hflip: bool = True, rotation: bool = True,
            rng: np.random.Generator | None = None) -> list[np.ndarray]:
    """Random horizontal flip, vertical flip and transpose (90-degree
    rotation), the same for every image of the list; contiguous copies."""
    rng = rng or np.random.default_rng()
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot90 = rotation and rng.random() < 0.5

    def _augment(img: np.ndarray) -> np.ndarray:
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    return [_augment(i) for i in imgs]
