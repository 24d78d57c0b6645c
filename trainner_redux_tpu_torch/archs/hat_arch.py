"""HAT (Hybrid Attention Transformer) in PyTorch.

Port of the JAX package's archs/hat_arch.py (upstream HAT and its hat_s,
hat_m, hat_l presets), with upstream HAT's module names, so `state_dict()`
has the official torch keys (`layers.{i}.residual_group.blocks.{j}.
conv_block.cab.0.weight`, `...overlap_attn.qkv.weight`, ...) and an
official checkpoint loads with `strict=True` once its recomputable buffers
(`relative_position_index_SA`, `relative_position_index_OCA`, `attn_mask`)
are dropped.

A residual group (RHAG) is HABs, then one OCAB, then a 3x3 conv:

- HAB: window attention plus `conv_scale` times a channel-attention conv
  branch (CAB) on the same LayerNorm output, then the pre-LN MLP. The
  attention goes through `fused_window_mhsa` (kernels #3 and #8 on the
  card, 16x16 windows) when `fused_window_mhsa_supported` says so, else
  through window partition and PyTorch attention; the MLP half through
  `fused_ln_mlp` (kernels #2 and #7) when `fused_mlp_supported` does.
- OCAB: queries from the windows, keys and values from overlapping windows
  of ws * (1 + overlap_ratio) tokens a side (the halo zero-padded, as
  upstream's nn.Unfold), in PyTorch with no kernel; then the same MLP half.

The network takes and returns NCHW images; the body runs on NHWC tokens.
DropPath (HABs only) draws from the `generator` attribute of each HAB, which
the model sets (`set_dropout_generator`). LayerNorm eps is 1e-5 throughout,
`patch_embed.norm` included. As in the JAX package, the upsampler is always
pixel shuffle and the residual connection one 3x3 conv.

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32; a
training forward in bf16 computes as the flax HAT does with
`dtype=bfloat16`: the input and the mean cast to bf16, every convolution,
Linear and LayerNorm through `arch_util.in_dtype`, the HABs' window
attention on the bf16 forms of #3/#8 (`fused_window_mhsa` on bf16 qkv) and
every MLP half on those of #2/#7 (`fused_ln_mlp` on a bf16 x), OCAB's
attention in PyTorch with its softmax in fp32 rounded to bf16, the
`conv_scale` mix and DropPath as bf16 operations; the output back to fp32.
An eval forward runs in fp32 (the fp32 twin).
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
from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale, fused_mlp_residual
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
    Mlp,
    PatchEmbedNorm,
    WindowAttention,
    _attn_mask,
    _conv_nhwc,
    bias_kinds,
    init_transformer_weights,
    window_partition,
    window_reverse,
)
from trainner_redux_tpu_torch.ops.window_attention import (
    fused_window_mhsa,
    fused_window_mhsa_supported,
    shift_mask_kinds,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


class ChannelAttention(nn.Module):
    """Squeeze-excite on the spatial mean (upstream's ChannelAttention)."""

    def __init__(self, num_feat: int, squeeze_factor: int) -> None:
        super().__init__()
        sq = max(1, num_feat // squeeze_factor)
        self.attention = nn.Sequential(
            SpatialMean(), nn.Conv2d(num_feat, sq, 1), nn.ReLU(),
            nn.Conv2d(sq, num_feat, 1), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * in_dtype(self.attention, x)


class CAB(nn.Module):
    """Channel attention conv branch, NCHW: conv, exact GELU, conv, SE."""

    def __init__(self, num_feat: int, compress_ratio: int = 3, squeeze_factor: int = 30) -> None:
        super().__init__()
        mid = max(1, num_feat // compress_ratio)
        self.cab = nn.Sequential(
            Conv2d(num_feat, mid, 3), nn.GELU(), Conv2d(mid, num_feat, 3),
            ChannelAttention(num_feat, squeeze_factor),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(self.cab, x)


class HAB(nn.Module):
    """Hybrid attention block: x + DropPath(W-MSA + conv_scale * CAB) on
    LN1(x), then the pre-LN MLP half. x is NHWC (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 16, shift_size: int = 0,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: float | None = None,
                 drop_path: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.qk_scale = qk_scale
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        kinds = shift_mask_kinds(window_size, shift_size) if shift_size > 0 else None
        self.register_buffer(
            "mask_kinds", None if kinds is None else torch.from_numpy(kinds), persistent=False
        )
        self.generator: torch.Generator | None = None  # DropPath masks; see the module doc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        xn = in_dtype(self.norm1, x)
        conv_x = _conv_nhwc(self.conv_block, xn)
        xs = torch.roll(xn, (-shift, -shift), dims=(1, 2)) if shift else xn
        if self.qk_scale is None and fused_window_mhsa_supported(h, w, ws, c, self.num_heads):
            qkv = in_dtype(self.attn.qkv, xs).contiguous()
            out = fused_window_mhsa(qkv, bias_kinds(self.attn, self.mask_kinds, shift),
                                    self.num_heads, self.attn.head_dim, ws)
            attn_x = in_dtype(self.attn.proj, out)
        else:
            mask = _attn_mask(h, w, ws, shift)
            if mask is not None:
                mask = torch.from_numpy(mask).to(x.device)
            attn_x = window_reverse(self.attn(window_partition(xs, ws), mask), ws, h, w)
        if shift:
            attn_x = torch.roll(attn_x, (shift, shift), dims=(1, 2))
        s1 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        x = x + droppath(attn_x + self.conv_scale * conv_x, s1)

        fused = fused_mlp_residual(x, self.norm2, self.mlp.fc1, self.mlp.fc2, self.drop_path,
                                   self.training, ws, self.generator)
        if fused is not None:
            return fused
        s2 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        return (x + droppath(self.mlp(in_dtype(self.norm2, x)), s2)).contiguous()


@lru_cache(maxsize=8)
def _ocab_rel_index(ws: int, ows: int) -> np.ndarray:
    """(ws^2, ows^2) relative position index between the window's and the
    overlapping window's grids, into the ((ws + ows - 1)^2, nh) table."""
    coords_q = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    # overlapping window coordinates relative to the query window's origin
    off = (ows - ws) // 2
    coords_k = (
        np.stack(np.meshgrid(np.arange(ows), np.arange(ows), indexing="ij")).reshape(2, -1)
        - off
    )
    rel = (coords_q[:, :, None] - coords_k[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ows - 1 - off
    rel[:, :, 1] += ows - 1 - off
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


class OCAB(nn.Module):
    """Overlapping cross-attention block: queries from the ws x ws windows,
    keys and values from the ows x ows windows around them (the halo
    zero-padded); then the pre-LN MLP half. No DropPath."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 16,
                 overlap_ratio: float = 0.5, qkv_bias: bool = True,
                 mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.head_dim = dim // num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window_size + self.overlap_win_size - 1) ** 2, num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_ocab_rel_index(window_size, self.overlap_win_size)),
            persistent=False,
        )
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, ows, nh, hd = self.window_size, self.overlap_win_size, self.num_heads, self.head_dim
        pad = (ows - ws) // 2
        qkv = in_dtype(self.qkv, in_dtype(self.norm1, x))
        q, kv = qkv[..., :c], qkv[..., c:]
        q = window_partition(q, ws)  # (b*nW, ws*ws, c)
        # the overlapping windows: stride ws over the zero-padded map
        kv = F.pad(kv, (0, 0, pad, pad, pad, pad))
        kv = kv.unfold(1, ows, ws).unfold(2, ows, ws)  # (b, nwh, nww, 2c, ows, ows)
        kv = kv.permute(0, 1, 2, 4, 5, 3).reshape(-1, ows * ows, 2 * c)
        k, v = kv[..., :c], kv[..., c:]
        nq, nk = ws * ws, ows * ows
        qh = q.reshape(-1, nq, nh, hd).transpose(1, 2)
        kh = k.reshape(-1, nk, nh, hd).transpose(1, 2)
        vh = v.reshape(-1, nk, nh, hd).transpose(1, 2)
        # in x's dtype, as flax's: bf16(q scale) k summed in fp32, the softmax
        # in fp32 rounded to bf16 before its product with v
        attn = (qh * hd**-0.5).float() @ kh.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(nq, nk, nh).permute(2, 0, 1)[None]
        out = (torch.softmax(attn, dim=-1).to(vh.dtype) @ vh).transpose(1, 2).reshape(-1, nq, c)
        x = x + window_reverse(in_dtype(self.proj, out), ws, h, w)

        fused = fused_mlp_residual(x, self.norm2, self.mlp.fc1, self.mlp.fc2, 0.0,
                                   self.training, ws)
        if fused is not None:
            return fused
        return (x + self.mlp(in_dtype(self.norm2, x))).contiguous()


class AttenBlocks(nn.Module):
    """HABs (shift 0 on even blocks, ws/2 on odd ones), then one OCAB."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 compress_ratio: int, squeeze_factor: int, conv_scale: float,
                 overlap_ratio: float, mlp_ratio: float, qkv_bias: bool,
                 qk_scale: float | None, drop_paths: list[float]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                compress_ratio, squeeze_factor, conv_scale, mlp_ratio, qkv_bias, qk_scale,
                drop_paths[i])
            for i in range(depth)
        ])
        self.overlap_attn = OCAB(dim, num_heads, window_size, overlap_ratio, qkv_bias, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.overlap_attn(x)


class RHAG(nn.Module):
    """Residual hybrid attention group: AttenBlocks, a 3x3 conv, a residual."""

    def __init__(self, dim: int, **kwargs) -> None:
        super().__init__()
        self.residual_group = AttenBlocks(dim, **kwargs)
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.residual_group(x)) + x


class HAT(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6), window_size: int = 16,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_path_rate: float = 0.1,
                 img_range: float = 1.0, upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv", num_feat: int = 64,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.upsampler = upsampler
        self.resi_connection = resi_connection
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        self.conv_first = Conv2d(in_chans, embed_dim, 3)
        self.patch_embed = PatchEmbedNorm(embed_dim, eps=1e-5)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = nn.ModuleList()
        cursor = 0
        for depth, heads in zip(depths, num_heads):
            self.layers.append(RHAG(
                embed_dim, depth=depth, num_heads=heads, window_size=window_size,
                compress_ratio=int(compress_ratio), squeeze_factor=int(squeeze_factor),
                conv_scale=conv_scale, overlap_ratio=overlap_ratio, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale, drop_paths=dpr[cursor : cursor + depth],
            ))
            cursor += depth
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3)
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
        window attention (#3/#8) and the MLP halves (#2/#7) have bf16 forms
        wherever their fp32 training forms run (the MLP's rows of at most
        256 channels, as the fp32 backward's), and the other branches
        compute in PyTorch, so none."""
        return None

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every HAB draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, HAB):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> HAT:
        return init_transformer_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32; in
        training computed in `compute_dtype`, at eval in fp32."""
        in_h, in_w = x.shape[2], x.shape[3]
        x = x.to(self.compute_dtype if self.training else torch.float32)
        mean = self.mean.to(x.dtype)
        if x.shape[1] == 3:
            x = (x - mean) * self.img_range
        ws = self.window_size
        ph, pw = (ws - in_h % ws) % ws, (ws - in_w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")

        feat = in_dtype(self.conv_first, x)
        body = in_dtype(self.patch_embed.norm, feat.permute(0, 2, 3, 1).contiguous())  # NHWC
        for layer in self.layers:
            body = layer(body)
        body = in_dtype(self.norm, body)
        feat = feat + in_dtype(self.conv_after_body, body.permute(0, 3, 1, 2))
        feat = in_dtype(self.conv_before_upsample, feat)
        out = in_dtype(self.conv_last, in_dtype(self.upsample, feat))
        if out.shape[1] == 3:
            out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _hat_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs
        for k in ("img_size", "patch_size", "ape", "patch_norm", "use_checkpoint", "drop_rate",
                  "attn_drop_rate"):
            kwargs.pop(k, None)
        # the JAX package's compute dtype (build_network_cast)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["depths"] = tuple(cfg.get("depths", (6, 6, 6, 6)))
        cfg["num_heads"] = tuple(cfg.get("num_heads", (6, 6, 6, 6)))
        return HAT(upscale=scale, **cfg)

    return factory


hat = ARCH_REGISTRY.register(_hat_factory(), name="hat")
# the presets pass mlp_ratio 2.0; the class default stays 4.0, as upstream's
hat_s = ARCH_REGISTRY.register(
    _hat_factory(embed_dim=144, depths=[6] * 6, num_heads=[6] * 6, window_size=16,
                 compress_ratio=24, squeeze_factor=24, mlp_ratio=2.0),
    name="hat_s",
)
hat_m = ARCH_REGISTRY.register(
    _hat_factory(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16,
                 mlp_ratio=2.0),
    name="hat_m",
)
hat_l = ARCH_REGISTRY.register(
    _hat_factory(embed_dim=180, depths=[6] * 12, num_heads=[6] * 12, window_size=16,
                 mlp_ratio=2.0),
    name="hat_l",
)
