"""SpanC (SPAN++), SPAN's body on re-parameterizable `RepConv`s with the
implicit upsampler `IGConv`, in PyTorch (port of the JAX package's
archs/spanpp_arch.py, registered as spanc and spanpp, and of the two
modules it takes from archs/rtmosr_arch.py, `SeqConv3x3` and `RepConv`).

- `SeqConv3x3`: a 1x1 to 2x the output width, the result padded by one
  pixel with the 1x1's bias (not zeros), then a 3x3 VALID; at eval the two
  folded into one 3x3. Its parameters are upstream's raw `k0`, `b0`, `k1`,
  `b1`.
- `RepConv`: alpha[0] * SeqConv3x3 + alpha[1] * a plain 3x3 + alpha[2] *
  Conv3XC (gain 2), each branch in its train or eval form.
- `IGConv`: from learned frequencies and amplitudes and the cell-centre
  coordinates of the scale, a Fourier basis through a 1x1 MLP
  (`query_kernel`) gives the weights of a 3x3 convolution to 3 * scale^2
  channels, then a pixel shuffle. The scale is the configured one.

The module tree is upstream's; the folded copies upstream also saves
(`conv_3x3_rep`, each Conv3XC's `eval_conv`) are recomputed, so they are
dropped on load. The compute dtype is the other conv families'
(span_arch.py): in bf16 the 1x1 MLP of IGConv computes in bf16 (the JAX
package's Dense layers with dtype=bfloat16), the basis in fp32, and the
generated kernel is cast to the activations' dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import ConvFamily, Conv2d, in_dtype, parse_dtype
from trainner_redux_tpu_torch.archs.span_arch import Conv3XC
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


class SeqConv3x3(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth_multiplier: int = 2) -> None:
        super().__init__()
        mid = int(out_ch * depth_multiplier)
        self.k0 = nn.Parameter(torch.empty(mid, in_ch, 1, 1))
        self.b0 = nn.Parameter(torch.zeros(mid))
        self.k1 = nn.Parameter(torch.empty(out_ch, mid, 3, 3))
        self.b1 = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            b0 = self.b0.to(dt).view(1, -1, 1, 1)
            y0 = F.pad(F.conv2d(x, self.k0.to(dt)) + b0, (1, 1, 1, 1))
            border = torch.ones(y0.shape[2:], dtype=dt, device=x.device)
            border[1:-1, 1:-1] = 0
            y0 = y0 + border * b0
            return F.conv2d(y0, self.k1.to(dt)) + self.b1.to(dt).view(1, -1, 1, 1)
        rk = torch.einsum("omhw,mi->oihw", self.k1, self.k0[:, :, 0, 0])
        rb = torch.einsum("m,omhw->o", self.b0, self.k1) + self.b1
        return F.conv2d(x, rk.to(dt), None, 1, 1) + rb.to(dt).view(1, -1, 1, 1)


class RepConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(3))
        self.conv1 = SeqConv3x3(in_ch, out_ch, 2)
        self.conv2 = Conv2d(in_ch, out_ch, 3)
        self.conv3 = Conv3XC(in_ch, out_ch, gain=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype)
        return (a[0] * self.conv1(x) + a[1] * in_dtype(self.conv2, x)
                + a[2] * self.conv3(x))


class SPABPP(nn.Module):
    """SpanC's SPAB: three RepConvs with SiLU; returns (out, silu(out1))."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.c1_r = RepConv(channels, channels)
        self.c2_r = RepConv(channels, channels)
        self.c3_r = RepConv(channels, channels)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out1_act = F.silu(self.c1_r(x))
        out3 = self.c3_r(F.silu(self.c2_r(out1_act)))
        return (out3 + x) * (torch.sigmoid(out3) - 0.5), out1_act


def make_coord(s: int) -> np.ndarray:
    """Cell-centre coordinates in [-1, 1], (2, s, s); channel 0 is the
    column (x) coordinate."""
    seq = (np.arange(s) + 0.5) / s * 2 - 1
    gy, gx = np.meshgrid(seq, seq, indexing="ij")
    return np.stack([gx, gy], 0).astype(np.float32)


class IGConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 3, implicit_dim: int = 256,
                 latent_layers: int = 4, max_scale: int = 4) -> None:
        super().__init__()
        n = dim * kernel_size * kernel_size
        self.dim, self.kernel_size, self.max_scale = dim, kernel_size, max_scale
        self.freq = nn.Parameter(torch.empty(n, implicit_dim, 1, 1))
        self.amplitude = nn.Parameter(torch.empty(n, implicit_dim, 1, 1))
        self.phase = nn.Conv2d(1, implicit_dim // 2, 1)
        layers: list[nn.Module] = []
        for _ in range(latent_layers):
            layers += [nn.Conv2d(implicit_dim, implicit_dim, 1), nn.ReLU()]
        layers.append(nn.Conv2d(implicit_dim, 3, 1))
        self.query_kernel = nn.Sequential(*layers)

    def kernel(self, scale: int, dtype: torch.dtype) -> torch.Tensor:
        """The generated (3 * scale^2, dim, k, k) weight, in `dtype`."""
        k, half = self.kernel_size, self.freq.shape[1] // 2
        coords = torch.from_numpy(make_coord(scale)).to(self.freq.device)
        freq = self.freq[:, :, 0, 0]
        f = (freq[:, :half, None, None] * coords[0] + freq[:, half:, None, None] * coords[1])
        r = 1.0 / min(scale, self.max_scale) * 2.0
        phase = r * self.phase.weight[:, 0, 0, 0] + self.phase.bias
        f = f + phase[None, :, None, None]
        basis = torch.cat([torch.cos(torch.pi * f), torch.sin(torch.pi * f)], dim=1)
        z = basis * self.amplitude  # (n, imp, s, s)
        z = in_dtype(self.query_kernel, z.to(dtype))  # (n, 3, s, s)
        z = z.reshape(self.dim, k, k, 3, scale, scale).permute(3, 4, 5, 0, 1, 2)
        return z.reshape(3 * scale * scale, self.dim, k, k)

    def forward(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        w = self.kernel(scale, x.dtype)
        return F.pixel_shuffle(F.conv2d(x, w.to(x.dtype), None, 1, self.kernel_size // 2), scale)


class SpanC(ConvFamily):
    def __init__(self, scale: int = 2, num_in_ch: int = 3, feature_channels: int = 48,
                 ig_kernel_size: int = 3, implicit_dim: int = 256, latent_layers: int = 4,
                 max_scale: int = 4, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        fc = feature_channels
        self.scale, self.compute_dtype = scale, compute_dtype
        self.conv0 = RepConv(num_in_ch, fc)
        for i in range(1, 7):
            setattr(self, f"block_{i}", SPABPP(fc))
        self.conv_2 = RepConv(fc, fc)
        self.conv_cat = Conv2d(fc * 4, fc, 1)
        self.upsampler = IGConv(fc, ig_kernel_size, implicit_dim, latent_layers, max_scale)
        # upstream's buffer holding the scale (IGConv's weights do not show
        # it), kept so that checkpoints load strictly
        self.register_buffer("MetaIGConv", torch.tensor([scale], dtype=torch.uint8))

    def init_weights(self, generator: torch.Generator) -> SpanC:
        """The convolutions as the other families; the raw SeqConv3x3
        kernels, IGConv's frequencies and amplitudes normal(0, 0.02)."""
        super().init_weights(generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, SeqConv3x3):
                    for p in (m.k0, m.k1):
                        p.normal_(0.0, 0.02, generator=generator)
            for p in (self.upsampler.freq, self.upsampler.amplitude):
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, 3, H*scale, W*scale), fp32."""
        x = x.to(self.input_dtype())
        feat = self.conv0(x)
        b1, _ = self.block_1(feat)
        b = b1
        for i in range(2, 7):
            b, out1 = getattr(self, f"block_{i}")(b)
        b = self.conv_2(b)
        y = in_dtype(self.conv_cat, torch.cat([feat, b, b1, out1], dim=1))
        return self.upsampler(y, self.scale).float()


@ARCH_REGISTRY.register(name="spanc")
def _spanc_factory(scale: int = 2, **kwargs) -> SpanC:
    for k in ("scale_list", "eval_base_scale"):
        kwargs.pop(k, None)
    dtype = parse_dtype(kwargs)
    return SpanC(scale=scale, compute_dtype=dtype, **kwargs)


ARCH_REGISTRY.register(_spanc_factory, name="spanpp")
