"""SPANPlus, SPAN with grouped SPAB stages and DySample, in PyTorch (port of
the JAX package's archs/spanplus_arch.py): spanplus (48 channels, one
stage with 4 inner blocks, DySample), spanplus_s (32 channels, 2 inner
blocks, DySample), spanplus_st (48, 4, pixel shuffle) and spanplus_sts
(32, 2, pixel shuffle).

The blocks are SPAN's with Mish (`SPABPlus`, which returns mish(out1), the
reference's in-place Mish); each stage (`SPABS`) is block_1, n blocks,
block_end, a Conv3XC and a 1x1 fusion of [x, out_end, out_b1, mish(out1 of
block_end)]. The upsampler is `DySample(fc, num_out_ch, scale)` with its 1x1
end convolution ("dys", the local sampler of radius 2), a 3x3 to
num_in_ch * scale^2 and a pixel shuffle ("ps"), or a 3x3 ("conv", scale 1).
The module tree is upstream's (`feats.0`, `feats.{i}.block_n.{j}`,
`upsampler.offset` / `.scope` / `.end_conv` or `upsampler.0`). Conv3XC
follows `self.training` and the compute dtype is the other conv families'
(span_arch.py).
"""

from __future__ import annotations

import torch
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    ConvFamily,
    Conv2d,
    DySample,
    in_dtype,
    mish,
    parse_dtype,
)
from trainner_redux_tpu_torch.archs.span_arch import Conv3XC
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


class SPABPlus(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        c = in_channels
        self.c1_r = Conv3XC(c, c, gain=2)
        self.c2_r = Conv3XC(c, c, gain=2)
        self.c3_r = Conv3XC(c, c, gain=2)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out1_act = mish(self.c1_r(x))
        out3 = self.c3_r(mish(self.c2_r(out1_act)))
        return (out3 + x) * (torch.sigmoid(out3) - 0.5), out1_act


class SPABS(nn.Module):
    def __init__(self, feature_channels: int, n_blocks: int = 4) -> None:
        super().__init__()
        fc = feature_channels
        self.block_1 = SPABPlus(fc)
        self.block_n = nn.ModuleList(SPABPlus(fc) for _ in range(n_blocks))
        self.block_end = SPABPlus(fc)
        self.conv_2 = Conv3XC(fc, fc, gain=2)
        self.conv_cat = Conv2d(fc * 4, fc, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_b1, _ = self.block_1(x)
        out = out_b1
        for block in self.block_n:
            out, _ = block(out)
        out_end, out_x_2 = self.block_end(out)
        out_end = self.conv_2(out_end)
        return in_dtype(self.conv_cat, torch.cat([x, out_end, out_b1, out_x_2], dim=1))


class SpanPlus(ConvFamily):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, blocks=(4,),
                 feature_channels: int = 48, upscale: int = 4, upsampler: str = "dys",
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        fc = feature_channels
        self.compute_dtype = compute_dtype
        self.feats = nn.ModuleList(
            [Conv3XC(num_in_ch, fc, gain=2), *(SPABS(fc, nb) for nb in blocks)])
        if upsampler == "ps":
            self.upsampler = nn.Sequential(Conv2d(fc, num_in_ch * upscale**2, 3),
                                           nn.PixelShuffle(upscale))
        elif upsampler == "dys":
            self.upsampler = DySample(fc, upscale, out_channels=num_out_ch,
                                      end_convolution=True)
        elif upsampler == "conv":
            if upscale != 1:
                raise ValueError(f"upsampler 'conv' is for scale 1, not {upscale}")
            self.upsampler = Conv2d(fc, num_out_ch, 3)
        else:
            raise ValueError(f"upsampler '{upsampler}': ps, dys or conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32."""
        feat = x.to(self.input_dtype())
        for m in self.feats:
            feat = m(feat)
        return in_dtype(self.upsampler, feat).float()


def _spanplus_factory(feature_channels: int, blocks: tuple, upsampler: str):
    def factory(scale: int = 4, num_in_ch: int = 3, num_out_ch: int = 3, blocks=blocks,
                feature_channels: int = feature_channels, drop_rate: float = 0.0,
                upsampler: str = upsampler, **kwargs) -> SpanPlus:
        del drop_rate  # unused upstream too
        dtype = parse_dtype(kwargs)
        if kwargs:
            raise TypeError(f"spanplus: unknown options {sorted(kwargs)}")
        return SpanPlus(num_in_ch, num_out_ch, tuple(blocks), feature_channels, scale,
                        upsampler, dtype)

    return factory


ARCH_REGISTRY.register(_spanplus_factory(48, (4,), "dys"), name="spanplus")
ARCH_REGISTRY.register(_spanplus_factory(32, (2,), "dys"), name="spanplus_s")
ARCH_REGISTRY.register(_spanplus_factory(48, (4,), "ps"), name="spanplus_st")
ARCH_REGISTRY.register(_spanplus_factory(32, (2,), "ps"), name="spanplus_sts")
