"""DAT (Dual Aggregation Transformer) in PyTorch.

Port of the JAX package's archs/dat_arch.py (upstream DAT and its dat,
dat_s, dat_2 and dat_light presets), with upstream DAT's module names, so
`state_dict()` has the official torch keys (`before_RG.1.weight`,
`layers.{i}.blocks.{j}.attn.attns.{b}.pos.pos1.0.weight`,
`...attn.dwconv.1.running_mean`, `...ffn.sg.conv.weight`, ...) and an
official checkpoint loads with `strict=True` once its recomputable buffers
(`rpe_biases`, `relative_position_index`, `attn_mask_*`,
`num_batches_tracked`) are dropped.

A residual group is DATBs, then a 3x3 conv. DATB `b_idx` even runs adaptive
spatial attention, odd adaptive channel attention, each beside a depthwise
conv branch joined by the interaction maps; then the SGFN feed-forward.

- Spatial attention splits the channels in two branches: the first half
  over windows of split_size[0] rows and split_size[1] columns, the second
  over the transposed rectangles, each rolled by half a window when the
  block shifts. qkv (not the image) is zero-padded to a multiple of the
  larger split size, and the output cropped back. A branch goes through
  `fused_rect_mhsa` (the rect forms of kernels #3 and #8 on the card) when
  `fused_rect_mhsa_supported` says so, with the dynamic position bias and
  the shift masks as its (K, nh, n, n) kind table; else through window
  partition and PyTorch attention.
- BatchNormNoStats holds `weight`, `bias`, `running_mean` and `running_var`
  as parameters, as the JAX package does: in train mode it normalizes with
  the batch statistics and updates no running average, in eval mode it uses
  the stored ones; the optimizer (AdamW's weight decay), the EMA and the
  checkpoints carry all four.

The network takes and returns NCHW images; the body runs on NHWC tokens.
DropPath draws from the `generator` attribute of each DATB, which the model
sets (`set_dropout_generator`). LayerNorm eps is 1e-5 and GELU exact
throughout; the residual connection is always one 3x3 conv, as in JAX.

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32; a
training forward in bf16 computes as the flax DAT does with
`dtype=bfloat16`: the input and the mean cast to bf16, every convolution,
Linear and LayerNorm through `arch_util.in_dtype`, the dynamic position
bias in bf16 and then fp32 as a kind table, the spatial branches on the
bf16 forms of the rect #3/#8 (`fused_rect_mhsa` on bf16 qkv) or, off the
kernels, in PyTorch with the softmax in fp32 rounded to bf16, DropPath as
a bf16 operation; BatchNormNoStats, the interaction maps' gating and the
channel attention's norms and scores each one fp32 pass rounded once, as
XLA fuses them; the output back to fp32. An eval forward runs in fp32 (the
fp32 twin).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    Conv2d,
    SpatialMean,
    droppath,
    in_dtype,
    parse_dtype,
)
from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale
from trainner_redux_tpu_torch.archs.swinir_arch import _MEAN, _conv_nhwc, init_transformer_weights
from trainner_redux_tpu_torch.ops.window_attention import (
    fused_rect_mhsa,
    fused_rect_mhsa_supported,
    rect_shift_mask_kinds,
    reference_rect_mhsa,
)
from trainner_redux_tpu_torch.utils.registry import SPANDREL_REGISTRY


# Parameters whose true gradient is 0, so that only rounding noise stands
# in their place: a per-head constant of the position bias cancels in the
# softmax, and a per-channel constant before a train-mode BatchNorm in its
# batch mean.
ZERO_GRAD_PARAMS = (".pos.pos3.2.bias", "dwconv.0.bias", "channel_interaction.1.bias",
                    "spatial_interaction.0.bias")


class BatchNormNoStats(nn.Module):
    """BatchNorm2d over NCHW with the JAX package's semantics: batch
    statistics (biased variance) in train mode with no running update, the
    stored `running_mean` / `running_var` in eval mode. All four tensors are
    parameters."""

    def __init__(self, num_features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.running_mean = nn.Parameter(torch.zeros(num_features))
        self.running_var = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In x's dtype, as the JAX module computes it under XLA, which fuses
        the statistics and the normalisation and keeps their fp32 (excess
        precision): for a bf16 x the batch mean and variance, the
        normalisation and the affine in fp32, rounded to bf16 once at the
        end. (Rounding the statistics too makes DAT's channel-interaction
        norm, over B values per channel, add noise to every gradient behind
        it: tests/test_torch_bf16_families.py.)"""
        if self.training:
            xf = x.float()
            mu = xf.mean(dim=(0, 2, 3), keepdim=True)
            var = xf.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        else:
            mu = self.running_mean.view(1, -1, 1, 1).to(x.dtype)
            var = self.running_var.view(1, -1, 1, 1).to(x.dtype)
        y = (x.float() - mu.float()) * torch.rsqrt(var.float() + self.eps)
        return (y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)).to(x.dtype)


def _depthwise(channels: int) -> nn.Conv2d:
    return nn.Conv2d(channels, channels, 3, padding=1, groups=channels)


class SpatialGate(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.conv = _depthwise(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, in_dtype(self.norm, x))


class SGFN(nn.Module):
    """Spatial-gate feed-forward on NHWC: half the hidden channels gate the
    other half through a LayerNorm and a depthwise conv."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.sg = SpatialGate(hidden_features // 2)
        self.fc2 = nn.Linear(hidden_features // 2, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.gelu(in_dtype(self.fc1, x)).chunk(2, dim=-1)
        return in_dtype(self.fc2, x1 * self.sg(x2))


@lru_cache(maxsize=64)
def rect_rel_index(h_sp: int, w_sp: int) -> np.ndarray:
    """(n, n) index of each token pair's relative offset into the
    ((2 h_sp - 1)(2 w_sp - 1), nh) position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(h_sp), np.arange(w_sp), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += h_sp - 1
    rel[:, :, 1] += w_sp - 1
    rel[:, :, 0] *= 2 * w_sp - 1
    return rel.sum(-1)


@lru_cache(maxsize=64)
def rect_bias_coords(h_sp: int, w_sp: int) -> np.ndarray:
    """((2 h_sp - 1)(2 w_sp - 1), 2) relative offsets, the position MLP's input."""
    bh = np.arange(1 - h_sp, h_sp)
    bw = np.arange(1 - w_sp, w_sp)
    return np.stack(np.meshgrid(bh, bw, indexing="ij")).reshape(2, -1).T.astype(np.float32)


@lru_cache(maxsize=128)
def rect_mask(hp: int, wp: int, h_sp: int, w_sp: int, sh: int, sw: int) -> np.ndarray:
    """Shifted rectangular-window attention mask (nW, n, n) of an hp x wp map
    rolled by (-sh, -sw): -100 between tokens from different regions."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -h_sp), slice(-h_sp, -sh), slice(-sh, None)):
        for wss in (slice(0, -w_sp), slice(-w_sp, -sw), slice(-sw, None)):
            img[hs, wss] = cnt
            cnt += 1
    m = img.reshape(hp // h_sp, h_sp, wp // w_sp, w_sp).transpose(0, 2, 1, 3)
    m = m.reshape(-1, h_sp * w_sp)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class DynamicPosBias(nn.Module):
    """The position MLP 2 -> pos_dim -> pos_dim -> pos_dim -> heads with
    pos_dim = dim // 4. At pos_dim 0 (tiny widths) only `pos3`'s bias is
    live: the output is that bias, as the JAX package's bias-only form."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.pos_dim = dim // 4
        pd = self.pos_dim
        self.pos_proj = nn.Linear(2, pd)
        self.pos1 = nn.Sequential(nn.LayerNorm(pd, eps=1e-5), nn.ReLU(), nn.Linear(pd, pd))
        self.pos2 = nn.Sequential(nn.LayerNorm(pd, eps=1e-5), nn.ReLU(), nn.Linear(pd, pd))
        self.pos3 = nn.Sequential(nn.LayerNorm(pd, eps=1e-5), nn.ReLU(), nn.Linear(pd, num_heads))

    def forward(self, biases: torch.Tensor) -> torch.Tensor:
        """The bias of each offset in `biases`' dtype (fp32 coordinates, or
        bf16 ones in a bf16 forward, as flax's with dtype=bfloat16)."""
        if self.pos_dim == 0:
            return in_dtype(self.pos3[2], biases.new_zeros(biases.shape[:-1] + (0,)))
        x = in_dtype(self.pos_proj, biases)
        for layer in (self.pos1, self.pos2, self.pos3):
            x = in_dtype(layer, x)
        return x


class SpatialAttentionBranch(nn.Module):
    """Attention of one branch (half the channels) over windows of h_sp rows
    and w_sp columns, from its packed [q | k | v] (B, H, W, 3 dim); the map
    arrives padded and, when shifted, rolled by (-sh, -sw)."""

    def __init__(self, dim: int, h_sp: int, w_sp: int, num_heads: int,
                 qk_scale: float | None = None, shift_hw: tuple[int, int] | None = None) -> None:
        super().__init__()
        self.dim = dim
        self.h_sp, self.w_sp = h_sp, w_sp
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qk_scale = qk_scale
        self.shift_hw = shift_hw
        self.pos = DynamicPosBias(dim // 4, num_heads)
        self.register_buffer("rpe_biases", torch.from_numpy(rect_bias_coords(h_sp, w_sp)),
                             persistent=False)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rect_rel_index(h_sp, w_sp)), persistent=False)
        kinds = rect_shift_mask_kinds(h_sp, w_sp, *shift_hw) if shift_hw else None
        self.register_buffer("mask_kinds", None if kinds is None else torch.from_numpy(kinds),
                             persistent=False)

    def position_bias(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(nh, n, n) dynamic position bias in fp32, computed in `dtype`."""
        n = self.h_sp * self.w_sp
        pos = self.pos(self.rpe_biases.to(dtype)).float()
        return pos[self.relative_position_index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, qkv: torch.Tensor) -> torch.Tensor:
        _, hp, wp, c3 = qkv.shape
        nh, hd = self.num_heads, self.head_dim
        bias = self.position_bias(qkv.dtype)[None]
        if self.qk_scale is None and fused_rect_mhsa_supported(hp, wp, self.h_sp, self.w_sp,
                                                               c3 // 3, nh):
            table = bias if self.mask_kinds is None else bias + self.mask_kinds[:, None]
            return fused_rect_mhsa(qkv.contiguous(), table.contiguous(), nh, hd,
                                   self.h_sp, self.w_sp)
        if self.shift_hw is not None:  # the per-window masks at this padded size
            mask = rect_mask(hp, wp, self.h_sp, self.w_sp, *self.shift_hw)
            bias = bias + torch.from_numpy(mask).to(bias.device)[:, None]
        return reference_rect_mhsa(qkv, bias, nh, hd, self.h_sp, self.w_sp, self.qk_scale)


def _interact(attened: torch.Tensor, att_map: torch.Tensor, conv_x: torch.Tensor,
              conv_map: torch.Tensor) -> torch.Tensor:
    """attened * sigmoid(att_map) + conv_x * sigmoid(conv_map), NHWC, from
    NHWC attened and NCHW maps and conv_x: one elementwise pass in fp32,
    rounded to attened's dtype at its end, as XLA fuses it (for a bf16
    forward; its gradients then sum fp32 products, as XLA's do)."""
    out = (attened.float() * torch.sigmoid(att_map.float()).permute(0, 2, 3, 1)
           + (conv_x.float() * torch.sigmoid(conv_map.float())).permute(0, 2, 3, 1))
    return out.to(attened.dtype)


def _interaction(dim: int) -> tuple[nn.Sequential, nn.Sequential]:
    """The channel and spatial interaction maps of the adaptive interaction
    module (upstream's Sequential indices)."""
    ci = max(1, dim // 8)
    si = max(1, dim // 16)
    channel = nn.Sequential(SpatialMean(), nn.Conv2d(dim, ci, 1), BatchNormNoStats(ci),
                            nn.GELU(), nn.Conv2d(ci, dim, 1))
    spatial = nn.Sequential(nn.Conv2d(dim, si, 1), BatchNormNoStats(si), nn.GELU(),
                            nn.Conv2d(si, 1, 1))
    return channel, spatial


class AdaptiveSpatialAttention(nn.Module):
    """Two rect-window branches on the two channel halves, and the depthwise
    conv branch on v, joined by the interaction maps. x is NHWC."""

    def __init__(self, dim: int, num_heads: int, split_size=(8, 32), shift_size=(4, 16),
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 do_shift: bool = False) -> None:
        super().__init__()
        self.dim = dim
        self.split_size = tuple(split_size)
        self.shift_size = tuple(shift_size)
        self.do_shift = do_shift
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        ssh, ssw = self.split_size
        sh0, sh1 = self.shift_size
        half = dim // 2
        self.attns = nn.ModuleList([
            SpatialAttentionBranch(half, ssh, ssw, num_heads // 2, qk_scale,
                                   (sh0, sh1) if do_shift else None),
            SpatialAttentionBranch(half, ssw, ssh, num_heads // 2, qk_scale,
                                   (sh1, sh0) if do_shift else None),
        ])
        self.dwconv = nn.Sequential(_depthwise(dim), BatchNormNoStats(dim), nn.GELU())
        self.channel_interaction, self.spatial_interaction = _interaction(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        qkv = in_dtype(self.qkv, x)
        v_img = qkv[..., 2 * c :]
        max_sp = max(self.split_size)
        ph, pw = (max_sp - h % max_sp) % max_sp, (max_sp - w % max_sp) % max_sp
        qkv = F.pad(qkv, (0, 0, 0, pw, 0, ph)).unflatten(-1, (3, c))
        hp, wp = h + ph, w + pw
        half = c // 2
        outs = []
        for i, branch in enumerate(self.attns):
            part = qkv[..., i * half : (i + 1) * half].reshape(b, hp, wp, 3 * half)
            if self.do_shift:
                sh, sw = branch.shift_hw
                out = branch(torch.roll(part, (-sh, -sw), dims=(1, 2)))
                out = torch.roll(out, (sh, sw), dims=(1, 2))
            else:
                out = branch(part)
            outs.append(out[:, :h, :w])
        attened = torch.cat(outs, dim=-1)

        conv_x = in_dtype(self.dwconv, v_img.permute(0, 3, 1, 2))
        ch_map = in_dtype(self.channel_interaction, conv_x)
        sp_map = in_dtype(self.spatial_interaction, attened.permute(0, 3, 1, 2))
        return in_dtype(self.proj, _interact(attened, ch_map, conv_x, sp_map))


def _l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """t / max(|t|, 1e-12) over the last axis, the norm in fp32 rounded to
    t's dtype (jnp.linalg.norm of a bf16 t sums in fp32)."""
    norm = torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True).to(t.dtype)
    return t / norm.clamp_min(1e-12)


class AdaptiveChannelAttention(nn.Module):
    """Transposed (channel x channel) attention with L2-normalized q and k
    and a learned per-head temperature, beside the depthwise conv branch.
    x is NHWC."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 qk_scale: float | None = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.dwconv = nn.Sequential(_depthwise(dim), BatchNormNoStats(dim), nn.GELU())
        self.channel_interaction, self.spatial_interaction = _interaction(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        qkv = in_dtype(self.qkv, x).reshape(b, h * w, 3, nh, c // nh)
        q, k, v = qkv.permute(2, 0, 3, 4, 1)  # each (B, nh, hd, N)
        v_img = qkv[:, :, 2].reshape(b, h, w, c)
        q, k = _l2_normalize(q), _l2_normalize(k)
        # the scores summed in fp32 and the softmax in fp32, rounded to x's dtype
        attn = torch.softmax((q.float() @ k.float().transpose(-2, -1)) * self.temperature, dim=-1)
        attened = (attn.to(v.dtype) @ v).permute(0, 3, 1, 2).reshape(b, h, w, c)

        conv_x = in_dtype(self.dwconv, v_img.permute(0, 3, 1, 2))
        ch_map = in_dtype(self.channel_interaction, attened.permute(0, 3, 1, 2))
        sp_map = in_dtype(self.spatial_interaction, conv_x)
        return in_dtype(self.proj, _interact(attened, sp_map, conv_x, ch_map))


class DATB(nn.Module):
    """x + DropPath(attention(LN1(x))), then x + DropPath(SGFN(LN2(x))); NHWC."""

    def __init__(self, dim: int, num_heads: int, split_size, shift_size,
                 expansion_factor: float, qkv_bias: bool, qk_scale: float | None,
                 drop_path: float, rg_idx: int, b_idx: int) -> None:
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        if b_idx % 2 == 0:
            # the shift rule differs between even and odd residual groups
            do_shift = (rg_idx % 2 == 0 and b_idx > 0 and (b_idx - 2) % 4 == 0) or (
                rg_idx % 2 != 0 and b_idx % 4 == 0)
            self.attn = AdaptiveSpatialAttention(dim, num_heads, split_size, shift_size,
                                                 qkv_bias, qk_scale, do_shift)
        else:
            self.attn = AdaptiveChannelAttention(dim, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = SGFN(dim, int(dim * expansion_factor), dim)
        self.generator: torch.Generator | None = None  # DropPath masks; see the module doc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        s1 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        x = x + droppath(self.attn(in_dtype(self.norm1, x)), s1)
        s2 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        return x + droppath(self.ffn(in_dtype(self.norm2, x)), s2)


class ResidualGroup(nn.Module):
    """DATBs, a 3x3 conv, a residual."""

    def __init__(self, blocks: list[DATB], dim: int) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.blocks:
            res = blk(res)
        return _conv_nhwc(self.conv, res) + x


class DAT(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 180,
                 split_size=(8, 32), depth=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
                 expansion_factor: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_path_rate: float = 0.1,
                 img_range: float = 1.0, resi_connection: str = "1conv",
                 upsampler: str = "pixelshuffle", num_feat: int = 64,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        self.resi_connection = resi_connection
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        self.conv_first = Conv2d(in_chans, embed_dim, 3)
        # upstream's Sequential(Rearrange, LayerNorm): the tokens are NHWC here
        self.before_RG = nn.Sequential(nn.Identity(), nn.LayerNorm(embed_dim, eps=1e-5))
        split_size = tuple(split_size)
        shift = (split_size[0] // 2, split_size[1] // 2)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depth))]
        self.layers = nn.ModuleList()
        cursor = 0
        for rg, (d, heads) in enumerate(zip(depth, num_heads)):
            blocks = [DATB(embed_dim, heads, split_size, shift, expansion_factor, qkv_bias,
                           qk_scale, dpr[cursor + j], rg, j) for j in range(d)]
            self.layers.append(ResidualGroup(blocks, embed_dim))
            cursor += d
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
        """Why this network cannot train in bf16 on the port, or None: the
        rect #3/#8 have bf16 forms at every window the kernels take, and the
        plain branch computes in PyTorch, so none."""
        return None

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every DATB draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, DATB):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> DAT:
        """Linear weights trunc-normal 0.02, zero biases, LayerNorm ones and
        zeros, torch's default conv init, from `generator`; BatchNormNoStats
        and the temperatures keep their ones and zeros, as upstream."""
        return init_transformer_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32; in
        training computed in `compute_dtype`, at eval in fp32."""
        in_h, in_w = x.shape[2], x.shape[3]
        x = x.to(self.compute_dtype if self.training else torch.float32)
        mean = self.mean.to(x.dtype)
        if x.shape[1] == 3:
            x = (x - mean) * self.img_range
        feat = in_dtype(self.conv_first, x)
        body = in_dtype(self.before_RG[1], feat.permute(0, 2, 3, 1).contiguous())  # NHWC tokens
        for layer in self.layers:
            body = layer(body)
        body = in_dtype(self.norm, body)
        feat = feat + in_dtype(self.conv_after_body, body.permute(0, 3, 1, 2))
        if self.upsampler == "pixelshuffledirect":
            out = in_dtype(self.upsample, feat)
        else:
            feat = in_dtype(self.conv_before_upsample, feat)
            out = in_dtype(self.conv_last, in_dtype(self.upsample, feat))
        if out.shape[1] == 3:
            out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _dat_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs
        for k in ("img_size", "use_chk", "drop_rate", "attn_drop_rate"):
            kwargs.pop(k, None)
        # the JAX package's compute dtype (build_network_cast)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["depth"] = tuple(cfg.get("depth", (6,) * 6))
        cfg["num_heads"] = tuple(cfg.get("num_heads", (6,) * 6))
        cfg["split_size"] = tuple(cfg.get("split_size", (8, 32)))
        cfg["expansion_factor"] = float(cfg.get("expansion_factor", 4.0))
        return DAT(upscale=scale, **cfg)

    return factory


dat = SPANDREL_REGISTRY.register(_dat_factory(), name="dat")
dat_s = SPANDREL_REGISTRY.register(_dat_factory(split_size=(8, 16), expansion_factor=2.0),
                                   name="dat_s")
dat_2 = SPANDREL_REGISTRY.register(_dat_factory(expansion_factor=2.0), name="dat_2")
dat_light = SPANDREL_REGISTRY.register(
    _dat_factory(embed_dim=60, depth=(18,), num_heads=(6,), expansion_factor=2.0,
                 upsampler="pixelshuffledirect"),
    name="dat_light",
)
