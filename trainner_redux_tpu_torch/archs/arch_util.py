"""Building blocks of the ported archs (PyTorch, NCHW convolutions).

Counterpart of the JAX package's archs/arch_util.py: `Conv2d` with the same
"same"-padding convention, and `bilinear_sample`. Pixel shuffle and
unshuffle are torch's own (`nn.PixelShuffle`, `F.pixel_unshuffle`), whose
channel ordering the JAX versions reproduce. Convolutions go to cuDNN, as
the JAX package left them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn


def Conv2d(in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Conv2d:  # noqa: N802
    """A kxk convolution with (k - 1) // 2 zero padding on each side."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2)


class SpatialMean(nn.Module):
    """The mean over H and W of NCHW x, kept as (N, C, 1, 1): what
    `nn.AdaptiveAvgPool2d(1)` computes, with no parameters, so a module
    list's indices stay upstream's. Its backward has a deterministic CUDA
    implementation, which adaptive pooling's lacks (`deterministic: true`
    runs the step under `torch.use_deterministic_algorithms`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


def bilinear_sample(img: torch.Tensor, coords_y: torch.Tensor,
                    coords_x: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NHWC `img` at absolute float pixel coordinates
    (N, Ho, Wo), each corner's index clamped to the image: a gather of four
    corners, as the JAX package computes it (`grid_sample` normalises
    coordinates and treats the border otherwise)."""
    n, h, w, _ = img.shape
    y0, x0 = torch.floor(coords_y), torch.floor(coords_x)
    wy, wx = (coords_y - y0)[..., None], (coords_x - x0)[..., None]
    bidx = torch.arange(n, device=img.device).view(n, 1, 1)

    def gather(yy, xx):
        yy = yy.clamp(0, h - 1).long()
        xx = xx.clamp(0, w - 1).long()
        return img[bidx, yy, xx]

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
