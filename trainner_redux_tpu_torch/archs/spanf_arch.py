"""SPANF, the fast SPAN variant with plain (already folded) convolutions, in
PyTorch (port of the JAX package's archs/spanf_arch.py): a grouped 3x3
`conv_near` (one group per input channel) at LR, five SPAB1 blocks (3x3
convolutions and SiLU, the parameter-free attention where a block keeps its
width), a 1x1 fusion of the concatenation, a 3x3 to C * scale^2 and a pixel
shuffle.

Upstream SPANF's checkpoints hold only the folded `eval_conv` of each
Conv3XC, so those are its weights here: `block_{i}.c{j}_r.eval_conv`,
`conv_2.eval_conv`. Compute dtype as the other conv families
(arch_util.ConvFamily).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import ConvFamily, Conv2d, in_dtype, parse_dtype
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


class FoldedConv(nn.Module):
    """A Conv3XC as upstream SPANF keeps it: its folded 3x3 `eval_conv`."""

    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.eval_conv = Conv2d(c_in, c_out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(self.eval_conv, x)


class SPAB1(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int | None = None, out_ch: int | None = None) -> None:
        super().__init__()
        mid, out = mid_ch or in_ch, out_ch or in_ch
        self.attend = in_ch == out
        self.c1_r = FoldedConv(in_ch, mid)
        self.c2_r = FoldedConv(mid, mid)
        self.c3_r = FoldedConv(mid, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y3 = self.c3_r(F.silu(self.c2_r(F.silu(self.c1_r(x)))))
        if self.attend:
            return (y3 + x) * (torch.sigmoid(y3) - 0.5)
        return y3


class SPANF(ConvFamily):
    def __init__(self, scale: int = 4, num_in_ch: int = 3, num_out_ch: int = 3,
                 feature_channels: int = 32, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        del num_out_ch  # the output has num_in_ch channels, as in the JAX package
        s, cin, fc = scale, num_in_ch, feature_channels
        self.compute_dtype = compute_dtype
        self.conv_near = nn.Conv2d(cin, cin * s * s, 3, padding=1, groups=cin, bias=False)
        self.block_1 = SPAB1(cin, fc, fc)
        for i in range(2, 6):
            setattr(self, f"block_{i}", SPAB1(fc))
        self.conv_cat = Conv2d(cin * s * s + 2 * fc, fc, 1)
        self.conv_2 = FoldedConv(fc, cin * s * s)
        self.upsampler = nn.PixelShuffle(s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32."""
        x = x.to(self.input_dtype())
        out_feature = in_dtype(self.conv_near, x)
        b1 = self.block_1(x)
        b = b1
        for i in range(2, 6):
            b = getattr(self, f"block_{i}")(b)
        y = in_dtype(self.conv_cat, torch.cat([out_feature, b, b1], dim=1))
        return self.upsampler(self.conv_2(y)).float()


@ARCH_REGISTRY.register(name="spanf")
def _spanf_factory(scale: int = 4, **kwargs) -> SPANF:
    kwargs.pop("bias", None)
    dtype = parse_dtype(kwargs)
    return SPANF(scale=scale, compute_dtype=dtype, **kwargs)
