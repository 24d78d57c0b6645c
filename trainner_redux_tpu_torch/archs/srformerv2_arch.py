"""SRFormerV2 in PyTorch: permuted self-attention v2 with a decoupled
squeeze width, and plain window-12 Swin blocks among the PSA blocks.

Port of the JAX package's archs/srformerv2_arch.py (reference
srformerv2_arch.py:1325-1638), with upstream's module names, so
`state_dict()` has the official torch keys
(`layers.{i}.residual_group.blocks.{j}.attn.q.weight`,
`...mlp.dwconv.depthwise_conv.0.weight`, `conv_after_body.weight`, ...) and
an upstream checkpoint loads with `strict=True` once its recomputable
buffers (`relative_position_index`, `aligned_relative_position_index`,
`attn_mask`) are dropped.

- PSA (`PSAv2`): K and V fold each 2x2 group of a window's tokens into one
  token of 4 * squeeze_dim channels, Q keeps full resolution; the aligned
  relative-position bias upsamples the permuted window's table to every
  query; a shifted block adds the dual-scale mask (full-resolution queries
  against half-resolution keys). Plain `torch.matmul` and softmax, as the
  JAX package computes it outside any kernel. ConvFFN: fc1, GELU, plus the
  GELU of a 5x5 depthwise conv, fc2.
- `SwinBlockV2`, inserted at block positions 0, 3 and 6 of every layer:
  12x12 windows (clamped to `img_size` when smaller), never shifted. Two
  branches, chosen as in the JAX package: the kernels (`fused_attn_block`,
  TPU kernel #1 with #6 as its backward, then `fused_ln_mlp`, #2 with #7)
  when `fused_block_supported` holds, in fp32 training only where the
  backward kernels fit too; else the plain modules (`TRAINNER_FUSED_BLOCK=0`
  or `TRAINNER_FUSED_ATTN=0`).

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32, and
a training forward in bf16 computes as the flax SRFormerV2 does with
`dtype=bfloat16`: the input and the mean cast to bf16, every convolution
(the depthwise 5x5 of ConvFFN too), Linear and LayerNorm through
`arch_util.in_dtype`, PSA's scores summed in fp32 from bf16(q scale) and k
with the softmax in fp32 rounded to bf16, the Swin blocks on the bf16 forms
of #1/#6 and #2/#7 wherever the JAX gate takes its kernel branch (a block
outside the bf16 kernels' limits raises on the card, naming them; the
plain branch computes in bf16 too); the output back to fp32. An eval
forward (validation, `test`, the EMA network) runs in fp32: the fp32 twin.

The input is reflect-padded to a multiple of lcm(window_size, Swin window),
so a 48x48 crop runs at 72x72 and a 128x128 image at 144x144. The PSA shift
is not clamped for small inputs, and PSA's scale is (dim // heads) ** -0.5,
not the squeezed head's, as upstream. GELU is exact (erf); every LayerNorm
uses eps 1e-5. There is no DropPath. The network takes and returns NCHW
images; the body runs on NHWC tokens.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import Conv2d, in_dtype, parse_dtype
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
    Mlp,
    PatchEmbedNorm,
    ResidualGroup,
    WindowAttention,
    _attn_mask,
    _bias_or_zeros,
    _conv_nhwc,
    bias_kinds,
    init_transformer_weights,
    window_partition,
    window_reverse,
)
from trainner_redux_tpu_torch.ops.fused_block import (
    attn_block_bwd_fits,
    fused_attn_block,
    fused_block_supported,
    fused_ln_mlp,
    ln_mlp_bwd_fits,
)
from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


@lru_cache(maxsize=64)
def _aligned_index(pws: int) -> np.ndarray:
    """(4 pws^2, pws^2) indices into the (2 pws - 1)^2 table: each full-
    resolution query of a window against each token of its permuted half."""
    coords = np.stack(np.meshgrid(np.arange(pws), np.arange(pws), indexing="ij"), 0)
    cf = coords.reshape(2, -1)
    rel = (cf[:, :, None] - cf[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += pws - 1
    rel[:, :, 1] += pws - 1
    rel[:, :, 0] *= 2 * pws - 1
    idx = rel.sum(-1)  # (pws^2, pws^2)
    idx = idx.reshape(pws, pws, 1, 1, pws * pws)
    idx = np.tile(idx, (1, 1, 2, 2, 1)).transpose(0, 2, 1, 3, 4)
    return idx.reshape(4 * pws * pws, pws * pws).astype(np.int64)


@lru_cache(maxsize=64)
def _psa_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray | None:
    """(nW, ws^2, ws^2 / 4) dual-scale shift mask (0 / -100), or None."""
    if shift == 0:
        return None

    def labels(hh, ww, win, sh):
        img = np.zeros((hh, ww), np.float32)
        cnt = 0
        sl = (slice(0, -win), slice(-win, -sh), slice(-sh, None))
        for a in sl:
            for b in sl:
                img[a, b] = cnt
                cnt += 1
        m = img.reshape(hh // win, win, ww // win, win).transpose(0, 2, 1, 3)
        return m.reshape(-1, win * win)

    full = labels(h, w, ws, shift)
    perm = labels(h // 2, w // 2, ws // 2, shift // 2)
    attn = full[:, :, None] - perm[:, None, :]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


class PSAv2(nn.Module):
    """Permuted self-attention over windows (B*nW, n, C): K and V at a
    quarter of the tokens and 4 * squeeze_dim channels."""

    def __init__(self, dim: int, window_size: int, num_heads: int, squeeze_dim: int,
                 qkv_bias: bool = True) -> None:
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.squeeze_dim = squeeze_dim
        self.scale = (dim // num_heads) ** -0.5
        pws = window_size // 2
        self.kv = nn.Linear(dim, squeeze_dim * 2, bias=qkv_bias)
        self.q = nn.Linear(dim, squeeze_dim * 4, bias=qkv_bias)
        self.proj = nn.Linear(squeeze_dim * 4, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * pws - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("aligned_relative_position_index",
                             torch.from_numpy(_aligned_index(pws)), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        b_, n, _ = x.shape
        pws, nh, sq = self.window_size // 2, self.num_heads, self.squeeze_dim
        hd = 4 * sq // nh
        # each 2x2 group of tokens -> one token of (dy, dx, squeeze) channels
        kv = in_dtype(self.kv, x).reshape(b_, pws, 2, pws, 2, 2, sq).permute(0, 1, 3, 5, 2, 4, 6)
        kv = kv.reshape(b_, n // 4, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]  # (b_, nh, n/4, hd)
        q = in_dtype(self.q, x).reshape(b_, n, nh, hd).transpose(1, 2)
        # in x's dtype, as flax's: bf16(q scale) k summed in fp32, the softmax
        # in fp32 rounded to bf16 before its product with v
        attn = (q * self.scale).float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[self.aligned_relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n // 4, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n // 4) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, n // 4)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b_, n, 4 * sq)
        return in_dtype(self.proj, out)


class DWConv(nn.Module):
    """Upstream's `dwconv`: a 5x5 depthwise conv and its GELU, on NHWC."""

    def __init__(self, hidden: int, kernel_size: int = 5) -> None:
        super().__init__()
        self.depthwise_conv = nn.Sequential(
            nn.Conv2d(hidden, hidden, kernel_size, 1, (kernel_size - 1) // 2, groups=hidden),
            nn.GELU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.depthwise_conv, x)


class ConvFFN(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = F.gelu(in_dtype(self.fc1, x), approximate="none")
        return in_dtype(self.fc2, z + self.dwconv(z))


class PSABlockV2(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 squeeze_dim: int, mlp_ratio: float = 2.0) -> None:
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = PSAv2(dim, window_size, num_heads, squeeze_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = ConvFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size  # not clamped, as upstream
        y = in_dtype(self.norm1, x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = _psa_mask(h, w, ws, shift)
        if mask is not None:
            mask = torch.from_numpy(mask).to(x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return (x + self.mlp(in_dtype(self.norm2, x))).contiguous()


class SwinBlockV2(nn.Module):
    """The plain Swin block (window 12, Mlp FFN) the reference's layers hold
    at positions 0, 3 and 6 (srformerv2_arch.py:996-1015)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 2.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        kinds = shift_mask_kinds(window_size, shift_size) if shift_size > 0 else None
        self.register_buffer(
            "mask_kinds", None if kinds is None else torch.from_numpy(kinds), persistent=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, H, W, C); H, W multiples of window_size
        b, h, w, c = x.shape
        ws, shift, nh = self.window_size, self.shift_size, self.num_heads
        attn, mlp = self.attn, self.mlp
        hidden = mlp.fc1.out_features
        fused = fused_block_supported(h, w, ws, c, nh, hidden)
        if fused and self.training and x.dtype == torch.float32:
            # a block too large for the fp32 backward kernels trains on the
            # plain modules, which compute the same function; a bf16 block
            # takes the bf16 forms wherever the JAX gate takes its kernels,
            # and on the card their wrappers raise outside their limits
            fused = attn_block_bwd_fits(h, w, ws, c, nh) and ln_mlp_bwd_fits(c, hidden)
        if fused:
            ones = torch.ones(b, device=x.device)
            z = fused_attn_block(
                x.contiguous(), self.norm1.weight, self.norm1.bias,
                attn.qkv.weight.t().contiguous(), _bias_or_zeros(attn.qkv),
                attn.proj.weight.t().contiguous(), attn.proj.bias,
                bias_kinds(attn, self.mask_kinds, shift), ones, nh, attn.head_dim, ws, 1e-5,
                shift=shift,
            )
            return fused_ln_mlp(
                z, self.norm2.weight, self.norm2.bias, mlp.fc1.weight.t().contiguous(),
                mlp.fc1.bias, mlp.fc2.weight.t().contiguous(), mlp.fc2.bias, ones, ws, 1e-5,
            )

        y = in_dtype(self.norm1, x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = _attn_mask(h, w, ws, shift)
        if mask is not None:
            mask = torch.from_numpy(mask).to(x.device)
        y = window_reverse(attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return (x + mlp(in_dtype(self.norm2, x))).contiguous()


class SRFormerLayer(nn.Module):
    """One layer: its blocks (PSA and Swin, in the reference's order), a 3x3
    conv, a residual."""

    def __init__(self, blocks: list[nn.Module], dim: int) -> None:
        super().__init__()
        self.residual_group = ResidualGroup(blocks)
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.residual_group(x)) + x


def block_kinds(depth: int, window_size: int) -> list[tuple[str, int]]:
    """(kind, shift) of a layer's blocks: `depth` PSA blocks, every second
    shifted by window_size // 2, and unshifted Swin blocks inserted at
    positions 0, 3 and 6 (at the end where the list is shorter)."""
    kinds = [("psa", 0 if i % 2 == 0 else window_size // 2) for i in range(depth)]
    for pos in (0, 3, 6):
        kinds.insert(min(pos, len(kinds)), ("swin", 0))
    return kinds


class SRFormerV2(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 240,
                 depths=(4,) * 6, num_heads=(8,) * 6, window_size: int = 36,
                 squeeze_dim: int = 60, mlp_ratio: float = 2.0, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", num_feat: int = 64,
                 img_size: int = 64, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.upsampler = upsampler
        # the Swin window clamps to img_size when that is smaller
        self.swin_window = 12 if img_size > 12 else img_size
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        self.conv_first = Conv2d(in_chans, embed_dim, 3)
        self.patch_embed = PatchEmbedNorm(embed_dim, eps=1e-5)
        self.layers = nn.ModuleList()
        for depth, heads in zip(depths, num_heads):
            blocks = [
                PSABlockV2(embed_dim, heads, window_size, shift, squeeze_dim, mlp_ratio)
                if kind == "psa"
                else SwinBlockV2(embed_dim, heads, self.swin_window, shift, mlp_ratio)
                for kind, shift in block_kinds(depth, window_size)
            ]
            self.layers.append(SRFormerLayer(blocks, embed_dim))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3)
        if upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(Conv2d(embed_dim, in_chans * upscale**2, 3),
                                          nn.PixelShuffle(upscale))
        else:
            self.conv_before_upsample = nn.Sequential(Conv2d(embed_dim, num_feat, 3),
                                                      nn.LeakyReLU(0.01))
            stages: list[nn.Module] = []
            s = upscale
            while s > 1:
                f = 3 if s % 3 == 0 else 2
                stages += [Conv2d(num_feat, num_feat * f * f, 3), nn.PixelShuffle(f)]
                s //= f
            self.upsample = nn.Sequential(*stages)
            self.conv_last = Conv2d(num_feat, in_chans, 3)

    def bf16_refusal(self) -> str | None:
        """Why this network cannot train in bf16 on the port, or None: its
        Swin blocks have their bf16 forms (#1/#6 at 12x12 windows, #2/#7),
        and PSA, ConvFFN and the plain branch compute in bf16 in PyTorch."""
        return None

    def init_weights(self, generator: torch.Generator) -> SRFormerV2:
        """Linear weights and bias tables trunc-normal 0.02, zero Linear
        biases, LayerNorm ones and zeros, torch's default conv init, from
        `generator`."""
        return init_transformer_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32; in
        training computed in `compute_dtype`, at eval in fp32."""
        in_h, in_w = x.shape[2], x.shape[3]
        x = x.to(self.compute_dtype if self.training else torch.float32)
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        # a multiple both window sizes divide, reflect-padded
        mult = self.window_size * self.swin_window // math.gcd(self.window_size, self.swin_window)
        ph, pw = (mult - in_h % mult) % mult, (mult - in_w % mult) % mult
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")

        feat = in_dtype(self.conv_first, x)
        body = in_dtype(self.patch_embed.norm, feat.permute(0, 2, 3, 1).contiguous())  # NHWC
        for layer in self.layers:
            body = layer(body)
        body = in_dtype(self.norm, body)
        feat = feat + in_dtype(self.conv_after_body, body.permute(0, 3, 1, 2))
        if self.upsampler == "pixelshuffledirect":
            out = in_dtype(self.upsample, feat)
        else:
            out = in_dtype(self.conv_last,
                           in_dtype(self.upsample, in_dtype(self.conv_before_upsample, feat)))
        out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _srformerv2_factory(scale: int = 4, **kwargs) -> SRFormerV2:
    for k in ("resi_connection", "use_checkpoint"):
        kwargs.pop(k, None)
    # the JAX package's compute dtype (build_network_cast)
    kwargs["compute_dtype"] = parse_dtype(kwargs)
    for k in ("depths", "num_heads"):
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    return SRFormerV2(upscale=scale, **kwargs)


srformerv2 = ARCH_REGISTRY.register(_srformerv2_factory, name="srformerv2")
