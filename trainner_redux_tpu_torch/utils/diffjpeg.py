"""Differentiable JPEG, quality per sample (port of the JAX package's
utils/diffjpeg.py).

RGB -> YCbCr (full swing), 4:2:0 chroma by 2x2 mean, per 8x8 block the DCT,
quantisation with the differentiable round r + (y - r)^3, dequantisation and
IDCT (`ops/jpeg_kernel.py`, kernel #15 on the card), nearest 2x chroma
upsampling, back to RGB. Images are NHWC in [0, 1]; H and W are
edge-padded to multiples of 16 inside and cropped back.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.ops import jpeg_kernel

# standard JPEG quantization tables
Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
C_TABLE = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)

_RGB_TO_YCC = [[0.299, -0.168736, 0.5], [0.587, -0.331264, -0.418688], [0.114, 0.5, -0.081312]]
_YCC_TO_RGB = [[1.0, 1.0, 1.0], [0.0, -0.344136, 1.772], [1.402, -0.714136, 0.0]]
_YCC_OFFSET = [0.0, 128.0, 128.0]


@lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """(64, 64) matrix: flattened 8x8 spatial block -> flattened DCT coeffs."""
    m = np.zeros((64, 64), dtype=np.float64)
    for u, v in itertools.product(range(8), range(8)):
        for x, y in itertools.product(range(8), range(8)):
            m[u * 8 + v, x * 8 + y] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos(
                (2 * y + 1) * v * np.pi / 16
            )
    alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7)
    scale = np.outer(alpha, alpha).reshape(-1) * 0.25
    return (m * scale[:, None]).astype(np.float32)


@lru_cache(maxsize=1)
def _idct_matrix_np() -> np.ndarray:
    """(64, 64) matrix mapping a coefficient vector back to spatial values."""
    return np.linalg.inv(_dct_matrix()).T.astype(np.float32)


def quality_to_factor(quality) -> torch.Tensor:
    """JPEG quality (1-100) -> quantisation scale factor, in fp32."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2.0) / 100.0


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8 * W/8, 64)."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, (h // 8) * (w // 8), 64)


def _from_blocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def _rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """NHWC RGB [0, 255] -> YCbCr [0, 255], full swing (the JPEG convention)."""
    mat = torch.tensor(_RGB_TO_YCC, dtype=x.dtype, device=x.device)
    return x @ mat + torch.tensor(_YCC_OFFSET, dtype=x.dtype, device=x.device)


def _ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    mat = torch.tensor(_YCC_TO_RGB, dtype=x.dtype, device=x.device)
    return (x - torch.tensor(_YCC_OFFSET, dtype=x.dtype, device=x.device)) @ mat


def diff_jpeg(img: torch.Tensor, quality) -> torch.Tensor:
    """JPEG round trip of NHWC RGB images in [0, 1] at `quality` (a number,
    or a (N,) tensor of per-sample qualities in [1, 100])."""
    n, h, w, c = img.shape
    if c != 3:
        raise ValueError(f"diff_jpeg takes RGB images, got {c} channels")
    factor = quality_to_factor(quality).to(img.device)
    factor = factor.expand(n) if factor.ndim == 0 else factor
    factor = factor.reshape(n, 1, 1)

    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = img.float()
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    hp, wp = h + ph, w + pw

    ycc = _rgb_to_ycbcr(x * 255.0)
    y = ycc[..., 0]
    # 2x2 chroma subsampling (average pooling, JPEG 4:2:0)
    cb = ycc[..., 1].reshape(n, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(n, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))

    def qtab(t: np.ndarray) -> torch.Tensor:  # (B, 64)
        tab = torch.from_numpy(t.reshape(-1)).to(img.device)
        return torch.clamp(tab[None, :] * factor[:, 0], 1.0, 255.0).contiguous()

    # the three planes' blocks through one call of the block transform
    channels = (y, cb, cr)
    q_y, q_c = qtab(Y_TABLE), qtab(C_TABLE)
    spatial = jpeg_kernel.jpeg_block_transform_planes(
        [(_to_blocks(ch - 128.0).contiguous(), q) for ch, q in zip(channels, (q_y, q_c, q_c))])
    y2, cb2, cr2 = (_from_blocks(sp, ch.shape[1], ch.shape[2]) + 128.0
                    for sp, ch in zip(spatial, channels))

    # chroma upsample (nearest 2x)
    cb_up = cb2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr_up = cr2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    out = _ycbcr_to_rgb(torch.stack([y2, cb_up, cr_up], dim=-1)) / 255.0
    return torch.clamp(out[:, :h, :w, :], 0.0, 1.0)
