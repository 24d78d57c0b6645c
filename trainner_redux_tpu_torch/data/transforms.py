"""Host-side transforms (numpy, HWC) of the evaluation path.

Parity: the JAX package's data/transforms.py. The random crop and the
flip/rotate augmentations belong to the training data path and come with it.
"""

from __future__ import annotations

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]
