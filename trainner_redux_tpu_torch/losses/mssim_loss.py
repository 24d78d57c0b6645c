"""SSIM / MS-SSIM losses on NCHW images (port of the JAX package's
losses/mssim_loss.py).

11x11 Gaussian window of sigma 1.5, applied VALID as two separable
band-matrix products (one per spatial axis), optional downsampling by
round(min(H, W) / 256), and Y-channel (YIQ luma, or BT.601 studio-swing
YCbCr) preprocessing of 3-channel inputs clipped to [0, 1]. `SSIMLoss`
returns loss_weight * (1 - score), as the JAX package's does, and
`MSSIMLoss` loss_weight * (1 - clip(score, 0, 1)) over five scales.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.losses.basic_loss import Loss
from trainner_redux_tpu_torch.losses.loss_util import avg_pool
from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_WINDOW, _SIGMA = 11, 1.5
# BT.601 studio-swing luma of RGB in [0, 1], in [0, 255] before the offset
_Y_COEF, _Y_OFFSET = (65.481, 128.553, 24.966), 16.0


def to_y_channel(x: torch.Tensor, color_space: str = "yiq") -> torch.Tensor:
    """NCHW RGB [0, 1] -> N1HW luma: full-range BT.601 for 'yiq', else the
    studio-swing Y of YCbCr."""
    if color_space == "yiq":
        coef = x.new_tensor([0.299, 0.587, 0.114]).view(1, 3, 1, 1)
        return (x * coef).sum(dim=1, keepdim=True)
    coef = x.new_tensor(_Y_COEF).view(1, 3, 1, 1)
    return ((x * coef).sum(dim=1, keepdim=True) + _Y_OFFSET) / 255.0


def preprocess_rgb(x: torch.Tensor, test_y_channel: bool, color_space: str = "yiq"):
    x = x.clamp(0.0, 1.0)
    if test_y_channel and x.shape[1] == 3:
        x = to_y_channel(x, color_space)
    return x


@lru_cache(maxsize=32)
def _band_matrix(size: int, sigma: float, n: int) -> np.ndarray:
    """(n, n - size + 1) banded matrix B with B[i + k, i] = g[k]: x @ B is a
    VALID 1D Gaussian filter along that axis."""
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    out = np.zeros((n, n - size + 1), np.float32)
    for i in range(n - size + 1):
        out[i : i + size, i] = g
    return out


def _filt(x: torch.Tensor) -> torch.Tensor:
    """VALID Gaussian blur of NCHW x, rows then columns."""
    h, w = x.shape[2], x.shape[3]
    bh = torch.from_numpy(_band_matrix(_WINDOW, _SIGMA, h)).to(x.device)
    bw = torch.from_numpy(_band_matrix(_WINDOW, _SIGMA, w)).to(x.device)
    return torch.einsum("ncmw,wk->ncmk", torch.einsum("nchw,hm->ncmw", x, bh), bw)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, downsample: bool = False,
         get_cs: bool = False):
    """Per-image SSIM of NCHW inputs (and the contrast-structure term)."""
    x, y = x.float(), y.float()
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    f = max(1, round(min(x.shape[2], x.shape[3]) / 256))
    if downsample and f > 1:
        x, y = avg_pool(x, f), avg_pool(y, f)
    mu1, mu2 = _filt(x), _filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filt(x * x) - mu1_sq
    sigma2_sq = _filt(y * y) - mu2_sq
    sigma12 = _filt(x * y) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    ssim_val = ssim_map.mean(dim=(1, 2, 3))
    if get_cs:
        return ssim_val, cs_map.mean(dim=(1, 2, 3))
    return ssim_val


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, downsample: bool = False,
            is_prod: bool = True) -> torch.Tensor:
    """Per-image MS-SSIM over five scales; between scales a 2x average pool
    after zero-padding odd sides on both ends (torch's avg_pool2d with
    padding h % 2)."""
    weights = torch.tensor(MS_WEIGHTS, device=x.device)
    mcs = []
    ssim_val = None
    size = tuple(x.shape[2:])
    for level in range(len(MS_WEIGHTS)):
        if min(x.shape[2], x.shape[3]) < _WINDOW:
            # the JAX package's loss fails here too, less plainly
            raise ValueError(
                f"MS-SSIM of {size[0]}x{size[1]} images: scale {level + 1} of "
                f"{len(MS_WEIGHTS)} is {x.shape[2]}x{x.shape[3]}, smaller than the "
                f"{_WINDOW}-tap window (both sides need at least 161 pixels)"
            )
        ssim_val, cs = ssim(x, y, data_range=data_range, downsample=downsample, get_cs=True)
        mcs.append(cs)
        ph, pw = x.shape[2] % 2, x.shape[3] % 2
        if ph or pw:
            x = F.pad(x, (pw, pw, ph, ph))
            y = F.pad(y, (pw, pw, ph, ph))
        x, y = avg_pool(x, 2), avg_pool(y, 2)
    mcs_arr = torch.stack(mcs, dim=0)
    if is_prod:
        return torch.prod(mcs_arr[:-1].clamp(min=1e-6) ** weights[:-1, None], dim=0) * (
            ssim_val.clamp(min=1e-6) ** weights[-1])
    w = weights / weights.sum()
    return (mcs_arr[:-1] * w[:-1, None]).sum(dim=0) + ssim_val * w[-1]


@LOSS_REGISTRY.register(name="ssimloss")
class SSIMLoss(Loss):
    def __init__(self, loss_weight: float = 1.0, channels: int = 3, downsample: bool = False,
                 test_y_channel: bool = True, color_space: str = "yiq",
                 crop_border: float = 0.0) -> None:
        super().__init__(loss_weight)
        self.downsample = downsample
        self.test_y_channel = test_y_channel
        self.color_space = color_space
        self.crop_border = int(crop_border)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.crop_border:
            cb = self.crop_border
            x, y = x[:, :, cb:-cb, cb:-cb], y[:, :, cb:-cb, cb:-cb]
        x = preprocess_rgb(x, self.test_y_channel, self.color_space)
        y = preprocess_rgb(y, self.test_y_channel, self.color_space)
        return self.loss_weight * (1.0 - ssim(x, y, downsample=self.downsample).mean())


@LOSS_REGISTRY.register(name="mssimloss")
class MSSIMLoss(Loss):
    def __init__(self, loss_weight: float = 1.0, channels: int = 3, downsample: bool = False,
                 test_y_channel: bool = True, is_prod: bool = True, color_space: str = "yiq",
                 include_luminance: bool = False) -> None:
        super().__init__(loss_weight)
        self.downsample = downsample
        self.test_y_channel = test_y_channel
        self.is_prod = is_prod
        self.color_space = color_space

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = preprocess_rgb(x, self.test_y_channel, self.color_space)
        y = preprocess_rgb(y, self.test_y_channel, self.color_space)
        score = ms_ssim(x, y, downsample=self.downsample, is_prod=self.is_prod)
        return self.loss_weight * (1.0 - score.mean().clamp(0.0, 1.0))
