"""Image IO and array<->image conversion.

Parity: upstream traiNNer-redux traiNNer/utils/img_util.py (tensor2img,
imfrombytes, imwrite). Loading uses cv2 (the pyvips dependency of the
reference is replaced by cv2, imported where it is used); arrays are float32
RGB in [0, 1], layout HWC on the host.
"""

from __future__ import annotations

import os
from os import path as osp

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")


def imfrombytes(content: bytes, flag: str = "color", float32: bool = True) -> np.ndarray:
    """Decode image bytes -> HWC **RGB** float32 [0,1] (or uint8 if float32=False)."""
    import cv2

    img_np = np.frombuffer(content, np.uint8)
    imread_flags = {
        "color": cv2.IMREAD_COLOR,
        "grayscale": cv2.IMREAD_GRAYSCALE,
        "unchanged": cv2.IMREAD_UNCHANGED,
    }
    img = cv2.imdecode(img_np, imread_flags[flag])
    if img is None:
        raise ValueError("Failed to decode image bytes")
    if img.ndim == 3 and img.shape[2] >= 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3 else cv2.COLOR_BGRA2RGB)
    elif img.ndim == 2:
        img = img[:, :, None]
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imread(path: str, flag: str = "color", float32: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return imfrombytes(f.read(), flag=flag, float32=float32)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write an HWC RGB image (uint8, or float in [0,1]) to disk."""
    import cv2

    if auto_mkdir:
        dir_name = osp.abspath(osp.dirname(file_path))
        os.makedirs(dir_name, exist_ok=True)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    return bool(cv2.imwrite(file_path, img))


def save_batch_grid(img_batch, file_path: str) -> None:
    """Save an NHWC float batch in [0, 1] (numpy or tensor) as one image,
    the samples side by side in a row: the OTF debug dumps."""
    arr = np.asarray(img_batch.detach().cpu() if hasattr(img_batch, "detach") else img_batch,
                     np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    imwrite(np.concatenate(list(arr), axis=1), file_path)


def tensor2img(
    tensor, rgb2bgr: bool = False, min_max: tuple[float, float] = (0.0, 1.0)
) -> np.ndarray:
    """CHW / NCHW numpy array -> HWC uint8 image (first in batch)."""
    arr = np.asarray(tensor).astype(np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    elif arr.ndim == 2:
        arr = arr[:, :, None]
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if rgb2bgr and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]
    if arr.shape[2] == 1:
        arr = arr[:, :, 0]
    return arr
