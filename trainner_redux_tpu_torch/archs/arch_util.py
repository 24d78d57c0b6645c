"""Building blocks of the ported archs (PyTorch, NCHW convolutions).

Counterpart of the JAX package's archs/arch_util.py: `Conv2d` with the same
"same"-padding convention. Pixel shuffle and unshuffle are torch's own
(`nn.PixelShuffle`, `F.pixel_unshuffle`), whose channel ordering the JAX
versions reproduce. Convolutions go to cuDNN, as the JAX package left them
to XLA.
"""

from __future__ import annotations

from torch import nn


def Conv2d(in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Conv2d:  # noqa: N802
    """A kxk convolution with (k - 1) // 2 zero padding on each side."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2)
