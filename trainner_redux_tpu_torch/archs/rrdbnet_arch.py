"""RRDBNet, the ESRGAN generator, in PyTorch (port of the JAX package's
archs/rrdbnet_arch.py): `esrgan` (64 filters, 23 RRDBs) and `esrgan_lite`
(32, 12).

Residual-in-residual dense blocks, nearest-neighbour x2 upsampling stages
and the pixel-unshuffle trick of the scale-1 and scale-2 models: the input
is reflect-padded to a multiple of the unshuffle factor, unshuffled (4x4
for scale 1, 2x2 for scale 2) so the core always upsamples by 4, and the
output cropped back to exactly scale x input. The module tree is BasicSR's
(`conv_first`, `body.{i}.rdb{j}.conv{k}`, `conv_body`, `conv_up{n}`,
`conv_hr`, `conv_last`).

Scale 3 is refused: the JAX package's RRDBNet declares `conv_up1` twice
there (rrdbnet_arch.py:104-110) and cannot be built (flax raises
NameInUseError), so there is no scale-3 ESRGAN to port.

Compute dtype as the other conv families (arch_util.ConvFamily): in bf16
every convolution goes through `in_dtype` and every residual is
`x5 * 0.2 + x` in bf16, 0.2 (and LeakyReLU's slope) rounded to bf16 as the
JAX package's weak-typed constants are (`arch_util.scale_by`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    ConvFamily,
    Conv2d,
    in_dtype,
    leaky_relu,
    nearest_repeat,
    parse_dtype,
    scale_by,
)
from trainner_redux_tpu_torch.utils.registry import SPANDREL_REGISTRY


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32) -> None:
        super().__init__()
        self.conv1 = Conv2d(num_feat, num_grow_ch, 3)
        self.conv2 = Conv2d(num_feat + num_grow_ch, num_grow_ch, 3)
        self.conv3 = Conv2d(num_feat + 2 * num_grow_ch, num_grow_ch, 3)
        self.conv4 = Conv2d(num_feat + 3 * num_grow_ch, num_grow_ch, 3)
        self.conv5 = Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(_lrelu(in_dtype(conv, torch.cat(feats, dim=1))))
        return scale_by(in_dtype(self.conv5, torch.cat(feats, dim=1)), 0.2) + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int = 32) -> None:
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return scale_by(self.rdb3(self.rdb2(self.rdb1(x))), 0.2) + x


class RRDBNet(ConvFamily):
    """`shuffle_factor` > 1 pixel-unshuffles the input first, after which
    the network upsamples by 4."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32,
                 shuffle_factor: int = 1, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        net_scale = scale if shuffle_factor == 1 else 4
        if net_scale == 3:
            raise ValueError(
                "esrgan at scale 3: the JAX package's RRDBNet declares conv_up1 twice at scale "
                "3 (rrdbnet_arch.py:104-110) and cannot be built (flax NameInUseError), so the "
                "port has no scale-3 ESRGAN; use scale 1, 2, 4 or 8")
        self.compute_dtype = compute_dtype
        self.scale, self.shuffle_factor = scale, shuffle_factor
        self.conv_first = Conv2d(num_in_ch, num_feat, 3)
        self.body = nn.Sequential(*(RRDB(num_feat, num_grow_ch) for _ in range(num_block)))
        self.conv_body = Conv2d(num_feat, num_feat, 3)
        self.n_up = int(math.log2(net_scale)) if net_scale > 1 else 0
        for i in range(self.n_up):
            setattr(self, f"conv_up{i + 1}", Conv2d(num_feat, num_feat, 3))
        self.conv_hr = Conv2d(num_feat, num_feat, 3)
        self.conv_last = Conv2d(num_feat, num_out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32."""
        x = x.to(self.input_dtype())
        in_h, in_w = x.shape[2], x.shape[3]
        f = self.shuffle_factor
        if f > 1:
            ph, pw = (f - in_h % f) % f, (f - in_w % f) % f
            if ph or pw:
                x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            x = F.pixel_unshuffle(x, f)
        feat = in_dtype(self.conv_first, x)
        feat = feat + in_dtype(self.conv_body, self.body(feat))
        for i in range(self.n_up):
            feat = nearest_repeat(feat, 2)
            feat = _lrelu(in_dtype(getattr(self, f"conv_up{i + 1}"), feat))
        out = in_dtype(self.conv_last, _lrelu(in_dtype(self.conv_hr, feat)))
        if f > 1:
            out = out[:, :, : in_h * self.scale, : in_w * self.scale]
        return out.float()


PIXEL_UNSHUFFLE_SCALES = (1, 2)


@SPANDREL_REGISTRY.register()
def esrgan(scale: int = 4, use_pixel_unshuffle: bool = True, in_nc: int = 3, out_nc: int = 3,
           num_filters: int = 64, num_blocks: int = 23, **kwargs) -> RRDBNet:
    """ESRGAN with the reference's scale mapping: scale 2 unshuffles by 2,
    scale 1 by 4, so the core always computes at x4."""
    dtype = parse_dtype(kwargs)
    if kwargs:
        raise TypeError(f"esrgan: unknown options {sorted(kwargs)}")
    if use_pixel_unshuffle and scale in PIXEL_UNSHUFFLE_SCALES:
        eff_in_nc = in_nc * 4 ** (3 - scale)
        return RRDBNet(eff_in_nc, out_nc, scale, num_filters, num_blocks,
                       shuffle_factor=int(math.sqrt(eff_in_nc / out_nc)), compute_dtype=dtype)
    return RRDBNet(in_nc, out_nc, scale, num_filters, num_blocks, compute_dtype=dtype)


@SPANDREL_REGISTRY.register()
def esrgan_lite(scale: int = 4, num_filters: int = 32, num_blocks: int = 12,
                **kwargs) -> RRDBNet:
    return esrgan(scale=scale, num_filters=num_filters, num_blocks=num_blocks, **kwargs)
