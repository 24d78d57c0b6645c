"""DRCT (dense-residual-connected transformer) in PyTorch.

Port of the JAX package's archs/drct_arch.py (upstream DRCT and its drct,
drct_l and drct_xl presets), with upstream's module names, so `state_dict()`
has the official torch keys (`layers.{i}.swin{k}.attn.qkv.weight`,
`layers.{i}.adjust{k}.weight`, `patch_embed.norm.weight`,
`conv_before_upsample.0.weight`, `upsample.{2k}.weight`, ...) and an
upstream checkpoint loads with `strict=True` once its recomputable buffers
(`relative_position_index`, `attn_mask`) are dropped.

Each residual dense group (`RDG`) runs five of SwinIR's `SwinBlock`s on the
dense concatenation of its input and the growth features before them, at
widths dim + k gc (180, 212, 244, 276, 308 in the presets). Block k > 1 has
nh - (width % nh) heads (6, 4, 2, 6, 4: heads of 30, 53, 122, 46 and 77
channels), blocks 4 and 5 an MLP ratio of 1, odd blocks a shift of ws / 2
(dropped by the block where min(H, W) <= ws). Each block but the last is
followed by a 1x1 `adjust` convolution to gc channels and LeakyReLU(0.2),
the last by one back to dim; the group returns x5 * 0.2 + x.

The blocks' windows are 16x16, outside the fused block kernels (#1, #4,
#5: 8x8 and 12x12), so every block takes SwinBlock's unfused branch: the
window attention on #3/#8 (`fused_window_mhsa`) at each head's width
(32-, 64- or 128-wide form), the MLP half on #2/#7 (`fused_ln_mlp`, rows of
up to 320 channels), as the JAX package runs them in its kernels.

DropPath (per group, linspace(0, drop_path_rate, groups)) draws from the
`generator` attribute of each block, which the model sets
(`set_dropout_generator`). The input has the mean (0.4488, 0.4371, 0.4040)
subtracted and is reflect-padded to a multiple of the window; the output is
cropped. `patch_embed.norm` (eps 1e-5, DRCT's) acts on the body branch
only.

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32; a
training forward in bf16 computes as the flax DRCT does with
`dtype=bfloat16`: the input and the mean cast to bf16, every convolution,
Linear and LayerNorm through `arch_util.in_dtype`, the blocks on the bf16
forms of #3/#8 and #2/#7, the LeakyReLU slopes and the 0.2 group scale
rounded to bf16 (`arch_util.scale_by`); the output back to fp32. An eval
forward runs in fp32 (the fp32 twin).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    Conv2d,
    LeakyReLU,
    in_dtype,
    leaky_relu,
    parse_dtype,
    scale_by,
)
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
    PatchEmbedNorm,
    SwinBlock,
    _conv_nhwc,
    init_transformer_weights,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


class RDG(nn.Module):
    """Residual dense group: five SwinBlocks at widths dim + k gc over the
    dense concatenation, each followed by a 1x1 adjust convolution (to gc
    with LeakyReLU(0.2), the last back to dim); out = x5 * 0.2 + x. NHWC."""

    def __init__(self, dim: int, growth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop_path: float) -> None:
        super().__init__()
        for i in range(5):
            width = dim + i * growth
            heads = num_heads if i == 0 else num_heads - (width % num_heads)
            shift = window_size // 2 if i % 2 == 1 else 0
            mlp = mlp_ratio if i < 3 else 1.0
            self.add_module(f"swin{i + 1}", SwinBlock(width, heads, window_size, shift, mlp,
                                                      drop_path=drop_path))
            self.add_module(f"adjust{i + 1}", Conv2d(width, growth if i < 4 else dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(1, 6):
            inp = torch.cat(feats, dim=-1) if len(feats) > 1 else x
            h = _conv_nhwc(getattr(self, f"adjust{i}"), getattr(self, f"swin{i}")(inp))
            if i < 5:
                feats.append(leaky_relu(h, 0.2))
        return scale_by(h, 0.2) + x


class DRCT(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 180,
                 depths=(6,) * 6, num_heads=(6,) * 6, window_size: int = 16, growth: int = 32,
                 mlp_ratio: float = 2.0, drop_path_rate: float = 0.1, img_range: float = 1.0,
                 num_feat: int = 64, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        self.conv_first = Conv2d(in_chans, embed_dim, 3)
        self.patch_embed = PatchEmbedNorm(embed_dim, eps=1e-5)
        # one drop-path rate a group; `depths` sets only their count, as upstream
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, len(depths))]
        self.layers = nn.ModuleList(
            RDG(embed_dim, growth, heads, window_size, mlp_ratio, dpr[i])
            for i, heads in enumerate(num_heads)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3)
        self.conv_before_upsample = nn.Sequential(Conv2d(embed_dim, num_feat, 3),
                                                  LeakyReLU(0.01))
        stages: list[nn.Module] = []
        s = upscale
        while s > 1:
            f = 3 if s % 3 == 0 else 2
            stages += [Conv2d(num_feat, num_feat * f * f, 3), nn.PixelShuffle(f)]
            s //= f
        self.upsample = nn.Sequential(*stages)
        self.conv_last = Conv2d(num_feat, in_chans, 3)

    def bf16_refusal(self) -> str | None:
        """Why this network cannot train in bf16 on the port, or None: every
        block's attention and MLP have the bf16 forms of #3/#8 and #2/#7, so
        none."""
        return None

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every SwinBlock draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, SwinBlock):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> DRCT:
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
        if x.shape[1] == 3:
            x = (x - mean) * self.img_range
        ws = self.window_size
        ph, pw = (ws - in_h % ws) % ws, (ws - in_w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")

        feat = in_dtype(self.conv_first, x)
        # patch_embed.norm on the body branch only
        body = in_dtype(self.patch_embed.norm, feat.permute(0, 2, 3, 1).contiguous())  # NHWC
        for layer in self.layers:
            body = layer(body)
        body = in_dtype(self.norm, body)
        feat = feat + in_dtype(self.conv_after_body, body.permute(0, 3, 1, 2))
        out = in_dtype(self.conv_last,
                       in_dtype(self.upsample, in_dtype(self.conv_before_upsample, feat)))
        if out.shape[1] == 3:
            out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _drct_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs, as the JAX factory drops them
        # (`gc` is upstream's name for the growth width)
        for k in ("img_size", "patch_size", "in_chans", "ape", "patch_norm", "use_checkpoint",
                  "drop_rate", "attn_drop_rate", "qkv_bias", "qk_scale", "resi_connection",
                  "gc", "upsampler", "depths"):
            if k == "gc" and k in kwargs:
                cfg["growth"] = kwargs.pop(k)
            else:
                kwargs.pop(k, None)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["num_heads"] = tuple(cfg.get("num_heads", (6,) * 6))
        cfg["depths"] = tuple(cfg.get("depths", (6,) * len(cfg["num_heads"])))
        return DRCT(upscale=scale, **cfg)

    return factory


drct = ARCH_REGISTRY.register(_drct_factory(), name="drct")
drct_l = ARCH_REGISTRY.register(
    _drct_factory(num_heads=(6,) * 12, depths=(6,) * 12), name="drct_l")
drct_xl = ARCH_REGISTRY.register(
    _drct_factory(num_heads=(6,) * 14, depths=(6,) * 14, window_size=16), name="drct_xl")
