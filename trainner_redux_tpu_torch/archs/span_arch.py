"""SPAN, the Swift Parameter-free Attention Network, in PyTorch (port of the
JAX package's archs/span_arch.py): `Conv3XC`, `SPAB` and `SPAN`, registered
as span (52 channels), span_s (48), span_f32, span_f64 and span_f96.

The module tree is upstream's, so `state_dict()` has its keys
(`conv_1.conv.0.weight`, `block_1.c1_r.sk.bias`, `upsampler.0.weight`, the
`no_norm` buffer of a network built with norm=False) and upstream
checkpoints load strictly once their `eval_conv` copies are dropped.

`Conv3XC` follows `self.training`, as the JAX module follows `train`:

- training form: the input zero-padded by one pixel, then 1x1 -> 3x3 VALID
  -> 1x1, plus a 1x1 skip of the unpadded input, so border pixels see
  conv0's bias (this is not a padded 3x3);
- eval form: one 3x3 convolution whose weight and bias are folded from the
  same parameters at every call (the skip kernel centre-padded into the
  3x3), a pure function of them: no `eval_conv` state to refresh.

Compute dtype (`compute_dtype`, as `build_network_cast` passes it): the
parameters stay fp32; a training forward in bf16 computes as the flax SPAN
does with `dtype=bfloat16` (every convolution through `arch_util.in_dtype`,
the attention and activations on bf16); an eval forward (validation,
`test`, the EMA network) computes in fp32, the JAX package's fp32 twin.
The output is fp32. `norm` subtracts the mean and scales by img_range with
no de-normalisation at the end, as upstream; the factories default to
norm=False and ignore `bias`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import ConvFamily, Conv2d, in_dtype, parse_dtype
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY, SPANDREL_REGISTRY

_MEAN = (0.4488, 0.4371, 0.4040)


class Conv3XC(nn.Module):
    """Re-parameterizable convolution: 1x1 -> 3x3 -> 1x1 (+ 1x1 skip) in
    training, one folded 3x3 at eval."""

    def __init__(self, c_in: int, c_out: int, gain: int = 1, stride: int = 1) -> None:
        super().__init__()
        self.stride = stride
        self.conv = nn.Sequential(
            nn.Conv2d(c_in, c_in * gain, 1),
            nn.Conv2d(c_in * gain, c_out * gain, 3, stride),
            nn.Conv2d(c_out * gain, c_out, 1),
        )
        self.sk = nn.Conv2d(c_in, c_out, 1, stride)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) of the one 3x3 convolution the chain equals, in
        fp32, differentiable in the parameters."""
        c0, c1, c2 = self.conv
        k1, k3 = c0.weight[:, :, 0, 0], c2.weight[:, :, 0, 0]
        w = torch.einsum("on,nmhw,mi->oihw", k3, c1.weight, k1)
        b = k3 @ (c1.weight.sum(dim=(2, 3)) @ c0.bias + c1.bias) + c2.bias
        return w + F.pad(self.sk.weight, (1, 1, 1, 1)), b + self.sk.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return in_dtype(self.conv, F.pad(x, (1, 1, 1, 1))) + in_dtype(self.sk, x)
        w, b = self.folded()
        return F.conv2d(x, w.to(x.dtype), None, self.stride, 1) + b.to(x.dtype)[:, None, None]


class SPAB(nn.Module):
    """Swift parameter-free attention block. Returns (out, silu(out1)): the
    reference's in-place SiLU makes the block hand its activated first
    output to `conv_cat`."""

    def __init__(self, in_channels: int, mid_channels: int | None = None,
                 out_channels: int | None = None) -> None:
        super().__init__()
        mid = mid_channels or in_channels
        out_c = out_channels or in_channels
        self.c1_r = Conv3XC(in_channels, mid, gain=2)
        self.c2_r = Conv3XC(mid, mid, gain=2)
        self.c3_r = Conv3XC(mid, out_c, gain=2)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out1_act = F.silu(self.c1_r(x))
        out3 = self.c3_r(F.silu(self.c2_r(out1_act)))
        sim_att = torch.sigmoid(out3) - 0.5
        return (out3 + x) * sim_att, out1_act


class SPAN(ConvFamily):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, feature_channels: int = 48,
                 upscale: int = 4, norm: bool = True, img_range: float = 255.0,
                 rgb_mean: tuple[float, float, float] = _MEAN,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        fc = feature_channels
        self.compute_dtype = compute_dtype
        self.norm, self.img_range = norm, img_range
        self.register_buffer("mean", torch.tensor(rgb_mean, dtype=torch.float32).view(1, 3, 1, 1),
                             persistent=False)
        if not norm:
            self.register_buffer("no_norm", torch.zeros(1))
        self.conv_1 = Conv3XC(num_in_ch, fc, gain=2)
        for i in range(1, 7):
            setattr(self, f"block_{i}", SPAB(fc))
        self.conv_cat = Conv2d(fc * 4, fc, 1)
        self.conv_2 = Conv3XC(fc, fc, gain=2)
        self.upsampler = nn.Sequential(Conv2d(fc, num_out_ch * upscale**2, 3),
                                       nn.PixelShuffle(upscale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32."""
        x = x.float()
        if self.norm:
            x = (x - self.mean) * self.img_range
        x = x.to(self.input_dtype())
        out_feature = self.conv_1(x)
        b1, _ = self.block_1(out_feature)
        b = b1
        for i in range(2, 6):
            b, _ = getattr(self, f"block_{i}")(b)
        b6, b5_2 = self.block_6(b)
        b6 = self.conv_2(b6)
        out = in_dtype(self.conv_cat, torch.cat([out_feature, b6, b1, b5_2], dim=1))
        return in_dtype(self.upsampler, out).float()


def _span_factory(feature_channels: int):
    def factory(scale: int = 4, num_in_ch: int = 3, num_out_ch: int = 3,
                feature_channels: int = feature_channels, bias: bool = True, norm: bool = False,
                img_range: float = 255.0, rgb_mean=_MEAN, **kwargs) -> SPAN:
        del bias  # every Conv3XC has biases, as in the JAX package
        dtype = parse_dtype(kwargs)
        if kwargs:
            raise TypeError(f"span: unknown options {sorted(kwargs)}")
        return SPAN(num_in_ch, num_out_ch, feature_channels, scale, norm, img_range,
                    tuple(rgb_mean), dtype)

    return factory


SPANDREL_REGISTRY.register(_span_factory(52), name="span")
SPANDREL_REGISTRY.register(_span_factory(48), name="span_s")
ARCH_REGISTRY.register(_span_factory(32), name="span_f32")
ARCH_REGISTRY.register(_span_factory(64), name="span_f64")
ARCH_REGISTRY.register(_span_factory(96), name="span_f96")
