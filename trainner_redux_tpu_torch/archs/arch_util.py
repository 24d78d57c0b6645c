"""Building blocks of the ported archs (PyTorch, NCHW convolutions).

Counterpart of the JAX package's archs/arch_util.py: `Conv2d` with the same
"same"-padding convention, channel-wise `PReLU`, `bilinear_sample`, `mish`,
the spectral-norm convolution `SNConv2d`, the DySample upsampler (with its
optional end convolution) and `init_conv_weights`. Pixel shuffle and
unshuffle are torch's own (`nn.PixelShuffle`, `F.pixel_unshuffle`), whose
channel ordering the JAX versions reproduce. Convolutions go to cuDNN, as
the JAX package left them to XLA.

`in_dtype` and `droppath` compute in the activations' dtype as the flax
modules do with `dtype=bfloat16` (the parameters stay fp32 and are cast at
use): the bf16 training forwards of SwinIR, HAT, DAT and SRFormerV2 and the
bf16 DUnet call them. `SNConv2d` through `in_dtype` takes bf16(W / sigma),
sigma from the fp32 weight; `DySample` computes its offsets in x's dtype and
its tap sum in fp32, as the JAX package's.
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize


def Conv2d(in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Conv2d:  # noqa: N802
    """A kxk convolution with (k - 1) // 2 zero padding on each side."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2)


def in_dtype(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """m(x), in x's dtype: for a bf16 x, what the flax layer computes with
    dtype=bfloat16. A convolution or Linear takes its weight cast to bf16
    (the product summed in fp32 and rounded to bf16) and adds its bias as a
    bf16 operation (rounded again); a LayerNorm takes fp32 statistics and
    affine and rounds the result; a Sequential applies its layers so; any
    other module (activations, PixelShuffle, modules that call `in_dtype`
    themselves) runs on x as it is. For an fp32 x, m(x)."""
    if x.dtype == torch.float32:
        return m(x)
    if isinstance(m, nn.Sequential):
        for sub in m:
            x = in_dtype(sub, x)
        return x
    if isinstance(m, nn.Conv2d):
        y = F.conv2d(x, m.weight.to(x.dtype), None, m.stride, m.padding, m.dilation, m.groups)
        return y + m.bias.to(x.dtype)[:, None, None] if m.bias is not None else y
    if isinstance(m, nn.Linear):
        y = F.linear(x, m.weight.to(x.dtype))
        return y + m.bias.to(x.dtype) if m.bias is not None else y
    if isinstance(m, nn.LayerNorm):
        return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(x.dtype)
    return m(x)


class PReLU(nn.Module):
    """Channel-wise PReLU (upstream's `nn.PReLU(num_parameters=C)`, whose
    `weight` key it keeps): where(x >= 0, x, alpha * x), alpha cast to x's
    dtype first, as the JAX package's PReLU computes it on a bf16 x."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.where(x >= 0, x, alpha * x)


@torch.no_grad()
def init_conv_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default init of every convolution of `net` (weights
    kaiming-uniform with a = sqrt(5), biases uniform in +-1/sqrt(fan_in)),
    drawn from `generator`; returns `net`. Other parameters keep the values
    their modules set."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return net


def parse_dtype(kwargs: dict) -> torch.dtype:
    """Pop the compute dtype `build_network_cast` passes as `dtype` (a
    torch dtype or its name; fp32 when absent) and check it."""
    dtype = kwargs.pop("dtype", None) or torch.float32
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {dtype}: float32 or bfloat16")
    return dtype


class ConvFamily(nn.Module):
    """What the conv families share: the compute dtype, the seeded init and
    no bf16 refusal (no kernel to lack)."""

    compute_dtype: torch.dtype = torch.float32

    def bf16_refusal(self) -> str | None:
        """None: a conv network computes in bf16 on cuDNN, with no kernel
        that could lack a bf16 form."""
        return None

    def init_weights(self, generator: torch.Generator) -> nn.Module:
        return init_conv_weights(self, generator)

    def input_dtype(self) -> torch.dtype:
        """The dtype a forward computes in: `compute_dtype` in training,
        fp32 at eval (the fp32 twin)."""
        return self.compute_dtype if self.training else torch.float32


@functools.lru_cache(maxsize=64)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def scale_by(x: torch.Tensor, c: float) -> torch.Tensor:
    """x * c with c first rounded to x's dtype: in a bf16 operation the JAX
    package's Python constants (weak-typed) are bf16, so `0.2 * x` scales
    by 0.2001953125 there; torch would scale by 0.2."""
    return x * _rounded(c, x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """where(x >= 0, x, slope * x), the slope in x's dtype (`scale_by`),
    as jax.nn.leaky_relu computes it."""
    return torch.where(x >= 0, x, scale_by(x, negative_slope))


class LeakyReLU(nn.Module):
    """`leaky_relu` as a module (no parameters)."""

    def __init__(self, negative_slope: float) -> None:
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


def nearest_repeat(x: torch.Tensor, s: int) -> torch.Tensor:
    """NCHW x with each pixel repeated s x s times: nearest-neighbour
    upsampling, the JAX package's jnp.repeat along H and W."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, s, w, s).reshape(n, c, h * s, w * s)


def droppath(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """DropPath of NHWC x with the per-sample keep scales s (B,) fp32 (0 or
    1/keep): x * s in fp32, rounded to x's dtype, as flax's `x / keep`
    computes it on a bf16 x."""
    return (x * s[:, None, None, None]).to(x.dtype)


class SpatialMean(nn.Module):
    """The mean over H and W of NCHW x, kept as (N, C, 1, 1): what
    `nn.AdaptiveAvgPool2d(1)` computes, with no parameters, so a module
    list's indices stay upstream's. Its backward has a deterministic CUDA
    implementation, which adaptive pooling's lacks (`deterministic: true`
    runs the step under `torch.use_deterministic_algorithms`). A bf16 x's
    mean is computed in fp32 and rounded, as jnp.mean's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


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


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return F.mish(x)


def _l2n(v: torch.Tensor) -> torch.Tensor:
    """v / (|v| + 1e-12), the JAX package's normalisation (torch's
    F.normalize divides by max(|v|, eps) instead)."""
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SpectralNorm(nn.Module):
    """The spectral-norm parametrization of a convolution weight, with the
    JAX package's semantics rather than torch's
    `nn.utils.parametrizations.spectral_norm`, which takes a power
    iteration and writes `_u` / `_v` on every training-mode forward.

    Train mode: v = l2n(W^T u), u' = l2n(W v) from the stored u, with no
    gradient, and sigma = u'^T W v, through which the gradient reaches W;
    nothing is written. Eval mode: sigma = u^T W v from the stored pair.
    The stored pair moves only in `refresh` (once a training step, from the
    weights of before the step). W is the weight as (out, in * kh * kw),
    torch's flattening, over which `_v` is indexed."""

    def __init__(self, weight: torch.Tensor) -> None:
        super().__init__()
        w_mat = weight.detach().flatten(1)
        self.register_buffer("_u", _l2n(torch.randn(w_mat.shape[0])))
        self.register_buffer("_v", _l2n(w_mat.T @ self._u))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        w_mat = weight.flatten(1)
        if self.training:
            with torch.no_grad():
                v = _l2n(w_mat.T @ self._u)
                u = _l2n(w_mat @ v)
        else:
            u, v = self._u, self._v
        return weight / (u @ w_mat @ v)

    @torch.no_grad()
    def refresh(self, weight: torch.Tensor) -> None:
        """One power iteration from the stored u, written back: what the
        JAX package's mutable forward stores. u' does not depend on the
        input, so no forward is needed."""
        w_mat = weight.detach().flatten(1)
        v = _l2n(w_mat.T @ self._u)
        self._u.copy_(_l2n(w_mat @ v))
        self._v.copy_(v)

    @torch.no_grad()
    def reset(self, generator: torch.Generator, weight: torch.Tensor) -> None:
        """A fresh u drawn from `generator`, and v = l2n(W^T u)."""
        w_mat = weight.detach().flatten(1)
        self._u.copy_(_l2n(torch.randn(self._u.shape, generator=generator)))
        self._v.copy_(_l2n(w_mat.T @ self._u))


def SNConv2d(in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,  # noqa: N802
             padding: int | None = None, bias: bool = True) -> nn.Conv2d:
    """A convolution whose weight is spectrally normalised (`SpectralNorm`),
    registered as a parametrization: its state-dict keys are upstream's
    `parametrizations.weight.original` and `parametrizations.weight.0._u` /
    `._v`. Padding defaults to (k - 1) // 2."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                     (kernel_size - 1) // 2 if padding is None else padding, bias=bias)
    parametrize.register_parametrization(conv, "weight", SpectralNorm(conv.weight))
    return conv


def spectral_norms(module: nn.Module) -> list[tuple[nn.Module, SpectralNorm]]:
    """(convolution, its SpectralNorm) of every spectral-norm layer."""
    return [(m, m.parametrizations.weight[0]) for m in module.modules()
            if parametrize.is_parametrized(m, "weight")
            and isinstance(m.parametrizations.weight[0], SpectralNorm)]


@torch.no_grad()
def refresh_spectral_norms(module: nn.Module) -> None:
    """Refresh the stored (u, v) of every spectral-norm layer of `module`."""
    for conv, sn in spectral_norms(module):
        sn.refresh(conv.parametrizations.weight.original)


def dysample_init_pos(scale: int, groups: int) -> torch.Tensor:
    """Upstream DySample's `init_pos` buffer, (1, 2 * groups * scale^2, 1,
    1): each subpixel's anchor (a - (scale - 1) / 2) / scale, x then y."""
    h = (torch.arange(scale, dtype=torch.float32) - (scale - 1) / 2) / scale
    yy, xx = torch.meshgrid(h, h, indexing="ij")
    return torch.stack([xx, yy]).unsqueeze(1).repeat(1, groups, 1, 1).reshape(1, -1, 1, 1)


def dysample_local(x: torch.Tensor, off: torch.Tensor, scale: int, groups: int,
                   radius: int) -> torch.Tensor:
    """DySample's bilinear resampling as a windowed tap sum, as the JAX
    package computes it.

    Output subpixel (sy, sx) of input pixel (i, j) samples (i + anchor[sy] +
    off_y, j + anchor[sx] + off_x). Bilinear interpolation at displacement
    (dy, dx) from the pixel is sum_{u,v} relu(1 - |dy - u|) * relu(1 - |dx -
    v|) * x[i + u, j + v] over the integer taps |u|, |v| <= radius, exact
    while |d| <= radius; the displacement is clamped to the window and to
    the image ([max(-r, -i), min(r, h - 1 - i)]), so a farther offset
    samples the window's edge. Each term is an elementwise product of a
    shifted copy of x: no gather in the forward and no scatter-add in the
    backward, whose result is then deterministic.

    x: (n, c, h, w); off: (n, 2, groups, scale, scale, h, w), coordinate 0
    = x, 1 = y. Returns (n, c, h * scale, w * scale), channels by group."""
    n, c, h, w = x.shape
    s, g, r = scale, groups, radius
    xg = F.pad(x, (r, r, r, r)).view(n, g, c // g, h + 2 * r, w + 2 * r)
    iy = torch.arange(h, dtype=x.dtype, device=x.device).view(h, 1)
    jx = torch.arange(w, dtype=x.dtype, device=x.device).view(1, w)
    lo_y, hi_y = (-iy).clamp(min=-r), ((h - 1) - iy).clamp(max=r)
    lo_x, hi_x = (-jx).clamp(min=-r), ((w - 1) - jx).clamp(max=r)
    taps = [(u, v, xg[:, :, :, u + r:u + r + h, v + r:v + r + w])
            for u in range(-r, r + 1) for v in range(-r, r + 1)]
    rows = []
    for sy in range(s):
        cols = []
        for sx in range(s):
            anchor_y, anchor_x = (sy - (s - 1) / 2) / s, (sx - (s - 1) / 2) / s
            ry = torch.clamp(off[:, 1, :, sy, sx] + anchor_y, lo_y, hi_y).unsqueeze(2)
            rx = torch.clamp(off[:, 0, :, sy, sx] + anchor_x, lo_x, hi_x).unsqueeze(2)
            wy = {u: torch.relu(1.0 - (ry - u).abs()) for u in range(-r, r + 1)}
            wx = {v: torch.relu(1.0 - (rx - v).abs()) for v in range(-r, r + 1)}
            acc = None
            for u, v, tap in taps:
                term = (wy[u] * wx[v]) * tap
                acc = term if acc is None else acc + term
            cols.append(acc.reshape(n, c, h, w))
        rows.append(torch.stack(cols, dim=-1))  # (n, c, h, w, sx)
    return torch.stack(rows, dim=3).reshape(n, c, h * s, w * s)


class DySample(nn.Module):
    """The dynamic upsampler (DySample): offsets from a 1x1 convolution,
    gated by 0.5 * sigmoid of a 1x1 `scope` convolution, added to the
    subpixel anchors, then bilinear resampling per channel group; with
    `end_convolution`, an `end_kernel` convolution to `out_channels` after
    the sampling, in either sampler mode (SPANPlus's upsampler). DUnet's
    decoder uses it without.

    The offset channels are laid out (coordinate, group, sy, sx), coordinate
    0 = x, as upstream's, so checkpoints load as they are; upstream's
    `init_pos` buffer is kept (the anchors it holds are recomputed). The
    sampler (TRAINNER_DYSAMPLE_MODE): 'local' (the default), the windowed
    tap sum `dysample_local` of radius TRAINNER_DYSAMPLE_RADIUS, else
    `local_radius`, else 2; 'gather', unbounded bilinear sampling with the
    corners clamped to the image (`bilinear_sample`). A bf16 x computes as
    the flax DySample with dtype=bfloat16: the two 1x1 convolutions and the
    offsets' gating in bf16, the sampling in fp32 from the bf16 x and
    offsets, its result rounded to bf16 (where the JAX package's next
    convolution casts it), the end convolution in bf16."""

    def __init__(self, in_channels: int, scale: int = 2, groups: int = 4,
                 local_radius: int | None = None, out_channels: int | None = None,
                 end_convolution: bool = False, end_kernel: int = 1) -> None:
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} do not split into {groups} groups")
        self.scale, self.groups, self.local_radius = scale, groups, local_radius
        offset_ch = 2 * groups * scale * scale
        self.offset = nn.Conv2d(in_channels, offset_ch, 1)
        self.scope = nn.Conv2d(in_channels, offset_ch, 1, bias=False)
        self.register_buffer("init_pos", dysample_init_pos(scale, groups))
        self.end_conv = (Conv2d(in_channels, out_channels or in_channels, end_kernel)
                         if end_convolution else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._sample(x)
        return out if self.end_conv is None else in_dtype(self.end_conv, out)

    def _sample(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        s, g = self.scale, self.groups
        off = in_dtype(self.offset, x) * torch.sigmoid(in_dtype(self.scope, x)) * 0.5
        off, xf = off.view(n, 2, g, s, s, h, w).float(), x.float()
        if os.environ.get("TRAINNER_DYSAMPLE_MODE", "local") == "local":
            radius = int(os.environ.get("TRAINNER_DYSAMPLE_RADIUS", "0")) or (
                self.local_radius or 2)
            return dysample_local(xf, off, s, g, radius).to(x.dtype)
        return self._gather(xf, off).to(x.dtype)

    def _gather(self, x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """Unbounded bilinear sampling of each group at its coordinates."""
        n, c, h, w = x.shape
        s, g = self.scale, self.groups
        # (n, coord, g, sy, sx, h, w) -> (n, g, h * s, w * s, coord)
        off = off.permute(0, 2, 5, 3, 6, 4, 1).reshape(n, g, h * s, w * s, 2)
        anchor = (torch.arange(s, dtype=x.dtype, device=x.device) - (s - 1) / 2) / s
        ys = torch.arange(h, dtype=x.dtype, device=x.device).repeat_interleave(s) + anchor.repeat(h)
        xs = torch.arange(w, dtype=x.dtype, device=x.device).repeat_interleave(s) + anchor.repeat(w)
        img = x.permute(0, 2, 3, 1)
        cg = c // g
        outs = [bilinear_sample(img[..., gi * cg:(gi + 1) * cg],
                                ys.view(1, -1, 1) + off[:, gi, :, :, 1],
                                xs.view(1, 1, -1) + off[:, gi, :, :, 0])
                for gi in range(g)]
        return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)
