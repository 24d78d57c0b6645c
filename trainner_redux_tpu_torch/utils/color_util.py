"""Color-space conversions on HWC numpy images, BT.601 constants.

The YCbCr conversion uses ITU-R BT.601 studio-swing constants (the same ones
cv2 and BasicSR use), since published PSNR-Y/SSIM-Y numbers depend on them
exactly. Inputs are float images in [0, 1].
"""

from __future__ import annotations

import numpy as np

# BT.601 full->studio swing RGB->YCbCr (inputs in [0,1], outputs in [0,255]
# before /255). Row order: Y, Cb, Cr; columns R, G, B.
_RGB2YCBCR_MAT = np.array(
    [
        [65.481, -37.797, 112.0],
        [128.553, -74.203, -93.786],
        [24.966, 112.0, -18.214],
    ],
    dtype=np.float64,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def rgb2ycbcr_np(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """HWC RGB [0,1] -> YCbCr [0,1] (studio swing). y_only returns HW."""
    img = img.astype(np.float64)
    if y_only:
        out = img @ _RGB2YCBCR_MAT[:, 0] + _YCBCR_OFFSET[0]
    else:
        out = img @ _RGB2YCBCR_MAT + _YCBCR_OFFSET
    return (out / 255.0).astype(np.float32)
