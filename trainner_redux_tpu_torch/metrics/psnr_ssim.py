"""PSNR / SSIM metrics on numpy images.

Parity: the numpy `calculate_psnr` / `calculate_ssim` of the JAX package's
metrics/psnr_ssim.py (cv2/matlab conventions): images in [0, 255] scale for
the SSIM constants, 11x11 Gaussian window sigma 1.5, optional Y-channel
evaluation and border cropping. The SSIM window is applied as a separable
"valid" filter in numpy: cv2.filter2D followed by the [5:-5] crop keeps only
the pixels whose window lies inside the image, so the border mode never
enters and cv2 is not needed.
"""

from __future__ import annotations

import numpy as np

from trainner_redux_tpu_torch.utils.color_util import rgb2ycbcr_np
from trainner_redux_tpu_torch.utils.registry import METRIC_REGISTRY


def _prepare(img: np.ndarray, crop_border: int, test_y_channel: bool) -> np.ndarray:
    """HWC float [0,1] RGB (or HW) -> evaluation array in [0,255] float64."""
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 2:
        img = img[..., None]
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel and img.shape[2] == 3:
        img = rgb2ycbcr_np(img.astype(np.float32), y_only=True).astype(np.float64)
        img = img[..., None] if img.ndim == 2 else img
    return img * 255.0


@METRIC_REGISTRY.register(name="calculate_psnr")
def calculate_psnr(
    img: np.ndarray,
    img2: np.ndarray,
    crop_border: int = 0,
    test_y_channel: bool = False,
    **kwargs,
) -> float:
    assert img.shape == img2.shape, f"Image shapes differ: {img.shape} vs {img2.shape}"
    a = _prepare(img, crop_border, test_y_channel)
    b = _prepare(img2, crop_border, test_y_channel)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) for sigma > 0."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _gauss_valid(img: np.ndarray) -> np.ndarray:
    """11x11 Gaussian (sigma 1.5) over the window positions inside `img`."""
    k = _gaussian_kernel()
    rows = sum(k[i] * img[i : img.shape[0] - 10 + i] for i in range(11))
    return sum(k[j] * rows[:, j : img.shape[1] - 10 + j] for j in range(11))


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    """cv2-convention single-channel SSIM on [0,255] float64."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    mu1 = _gauss_valid(img)
    mu2 = _gauss_valid(img2)
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _gauss_valid(img**2) - mu1_sq
    sigma2_sq = _gauss_valid(img2**2) - mu2_sq
    sigma12 = _gauss_valid(img * img2) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


@METRIC_REGISTRY.register(name="calculate_ssim")
def calculate_ssim(
    img: np.ndarray,
    img2: np.ndarray,
    crop_border: int = 0,
    test_y_channel: bool = False,
    **kwargs,
) -> float:
    assert img.shape == img2.shape, f"Image shapes differ: {img.shape} vs {img2.shape}"
    a = _prepare(img, crop_border, test_y_channel)
    b = _prepare(img2, crop_border, test_y_channel)
    ssims = [_ssim_channel(a[..., i], b[..., i]) for i in range(a.shape[2])]
    return float(np.mean(ssims))
