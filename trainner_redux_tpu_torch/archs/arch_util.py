"""Building blocks of the ported archs (PyTorch, NCHW convolutions).

Counterpart of the JAX package's archs/arch_util.py: `Conv2d` with the same
"same"-padding convention, `bilinear_sample`, `mish`, the spectral-norm
convolution `SNConv2d` and the DySample upsampler. Pixel shuffle and
unshuffle are torch's own (`nn.PixelShuffle`, `F.pixel_unshuffle`), whose
channel ordering the JAX versions reproduce. Convolutions go to cuDNN, as
the JAX package left them to XLA.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize


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
    """The dynamic upsampler (DySample), as DUnet's decoder uses it (no end
    convolution): offsets from a 1x1 convolution, gated by 0.5 * sigmoid
    of a 1x1 `scope` convolution, added to the subpixel anchors, then
    bilinear resampling per channel group.

    The offset channels are laid out (coordinate, group, sy, sx), coordinate
    0 = x, as upstream's, so checkpoints load as they are; upstream's
    `init_pos` buffer is kept (the anchors it holds are recomputed). The
    sampler (TRAINNER_DYSAMPLE_MODE): 'local' (the default), the windowed
    tap sum `dysample_local` of radius TRAINNER_DYSAMPLE_RADIUS, else
    `local_radius`, else 2; 'gather', unbounded bilinear sampling with the
    corners clamped to the image (`bilinear_sample`)."""

    def __init__(self, in_channels: int, scale: int = 2, groups: int = 4,
                 local_radius: int | None = None) -> None:
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} do not split into {groups} groups")
        self.scale, self.groups, self.local_radius = scale, groups, local_radius
        offset_ch = 2 * groups * scale * scale
        self.offset = nn.Conv2d(in_channels, offset_ch, 1)
        self.scope = nn.Conv2d(in_channels, offset_ch, 1, bias=False)
        self.register_buffer("init_pos", dysample_init_pos(scale, groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        s, g = self.scale, self.groups
        off = (self.offset(x) * torch.sigmoid(self.scope(x)) * 0.5).view(n, 2, g, s, s, h, w)
        if os.environ.get("TRAINNER_DYSAMPLE_MODE", "local") == "local":
            radius = int(os.environ.get("TRAINNER_DYSAMPLE_RADIUS", "0")) or (
                self.local_radius or 2)
            return dysample_local(x, off, s, g, radius)
        return self._gather(x, off)

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
