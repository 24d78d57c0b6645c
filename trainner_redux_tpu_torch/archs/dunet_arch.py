"""DUnet, the GAN discriminator of the port (port of the JAX package's
archs/dunet_arch.py): a spectrally normalised U-Net with Mish activations
and DySample upsamplers.

The module tree is upstream's, so upstream checkpoints load as they are:
`in_to_dim`, `e_x{1,2,3}` = (SNConv2d stride 2, Mish), `up{1,2,3}` =
(DySample, SNConv2d), `end_conv` = (SNConv2d, Mish, SNConv2d, Mish, Conv2d).
The upsamplers sample a window of radius 1, as the JAX package's do.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    Conv2d,
    DySample,
    SNConv2d,
    spectral_norms,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


def _down(dim: int) -> nn.Sequential:
    return nn.Sequential(SNConv2d(dim, dim * 2, 3, 2, 1), nn.Mish())


def _up(dim: int) -> nn.Sequential:
    return nn.Sequential(
        DySample(dim, scale=2, groups=4, local_radius=1),
        SNConv2d(dim, dim // 2, 3, 1, 1),
    )


@ARCH_REGISTRY.register(name="dunet")
class DUnet(nn.Module):
    def __init__(self, num_in_ch: int = 3, num_feat: int = 64) -> None:
        super().__init__()
        nf = num_feat
        self.in_to_dim = Conv2d(num_in_ch, nf, 3)
        self.e_x1 = _down(nf)
        self.e_x2 = _down(nf * 2)
        self.e_x3 = _down(nf * 4)
        self.up1 = _up(nf * 8)
        self.up2 = _up(nf * 4)
        self.up3 = _up(nf * 2)
        self.end_conv = nn.Sequential(
            SNConv2d(nf, nf, 3, 1, 1, bias=False), nn.Mish(),
            SNConv2d(nf, nf, 3, 1, 1, bias=False), nn.Mish(),
            Conv2d(nf, 1, 3),
        )

    def init_weights(self, generator: torch.Generator) -> DUnet:
        """torch's default convolution init drawn from `generator`, then a
        fresh u for each spectral norm; returns the network."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                w = m.parametrizations.weight.original if hasattr(m, "parametrizations") \
                    else m.weight
                with torch.no_grad():
                    nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
                    if m.bias is not None:
                        bound = 1.0 / math.sqrt(w[0].numel())
                        nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        for conv, sn in spectral_norms(self):
            sn.reset(generator, conv.parametrizations.weight.original)
        return self

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x (N, C, H, W), H and W multiples of 8 -> logits (N, 1, H, W);
        with `return_features`, also [x1, x2, x3, u], the encoder's three
        outputs and the last decoder sum."""
        x0 = self.in_to_dim(x)
        x1 = self.e_x1(x0)
        x2 = self.e_x2(x1)
        x3 = self.e_x3(x2)
        u = self.up1(x3) + x2
        u = self.up2(u) + x1
        u = self.up3(u) + x0
        out = self.end_conv(u)
        if return_features:
            return out, [x1, x2, x3, u]
        return out
