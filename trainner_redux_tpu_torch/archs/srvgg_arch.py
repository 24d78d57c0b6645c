"""SRVGGNetCompact, Real-ESRGAN's "Compact" family, in PyTorch (port of the
JAX package's archs/srvgg_arch.py): compact (64 features, 16 convolutions),
ultracompact (64, 8), superultracompact (24, 8) and srvggnetcompact.

A plain stack of 3x3 convolutions and activations, a last convolution to
C * scale^2 channels and a pixel shuffle, plus the nearest-neighbour repeat
of the input as a residual. The module tree is upstream's (`body.{2i}` the
convolutions, `body.{2i+1}` the activations, PReLU's `weight` among them).

Compute dtype as the other conv families (arch_util.ConvFamily): a bf16
training forward computes the body in bf16 through `in_dtype`; the
residual, the repeat of the fp32 input, is cast to the output's dtype
before the add and the sum then cast to fp32 (in bf16 that rounding order
is the result). No train/eval difference but the dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    ConvFamily,
    Conv2d,
    LeakyReLU,
    PReLU,
    in_dtype,
    nearest_repeat,
    parse_dtype,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY, SPANDREL_REGISTRY

_ACTS = {"relu": nn.ReLU, "leakyrelu": lambda: LeakyReLU(0.1)}


class SRVGGNetCompact(ConvFamily):
    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 16, upscale: int = 4, act_type: str = "prelu",
                 learn_residual: bool = True, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if act_type not in ("prelu", *_ACTS):
            raise ValueError(f"unsupported act_type {act_type}")
        self.compute_dtype = compute_dtype
        self.upscale, self.learn_residual = upscale, learn_residual

        def act() -> nn.Module:
            return PReLU(num_feat) if act_type == "prelu" else _ACTS[act_type]()

        body: list[nn.Module] = [Conv2d(num_in_ch, num_feat, 3), act()]
        for _ in range(num_conv):
            body += [Conv2d(num_feat, num_feat, 3), act()]
        body.append(Conv2d(num_feat, num_out_ch * upscale**2, 3))
        self.body = nn.ModuleList(body)
        self.upsampler = nn.PixelShuffle(upscale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32."""
        inp = x.float()
        y = inp.to(self.input_dtype())
        for m in self.body:
            y = in_dtype(m, y)
        out = self.upsampler(y)
        if self.learn_residual:
            out = out + nearest_repeat(inp, self.upscale).to(out.dtype)
        return out.float()


@SPANDREL_REGISTRY.register()
def compact(scale: int = 4, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
            num_conv: int = 16, act_type: str = "prelu", learn_residual: bool = True,
            **kwargs) -> SRVGGNetCompact:
    dtype = parse_dtype(kwargs)
    if kwargs:
        raise TypeError(f"compact: unknown options {sorted(kwargs)}")
    return SRVGGNetCompact(num_in_ch, num_out_ch, num_feat, num_conv, scale, act_type,
                           learn_residual, dtype)


@SPANDREL_REGISTRY.register()
def ultracompact(scale: int = 4, num_feat: int = 64, num_conv: int = 8,
                 **kwargs) -> SRVGGNetCompact:
    return compact(scale=scale, num_feat=num_feat, num_conv=num_conv, **kwargs)


@SPANDREL_REGISTRY.register()
def superultracompact(scale: int = 4, num_feat: int = 24, num_conv: int = 8,
                      **kwargs) -> SRVGGNetCompact:
    return compact(scale=scale, num_feat=num_feat, num_conv=num_conv, **kwargs)


ARCH_REGISTRY.register(compact, name="srvggnetcompact")
