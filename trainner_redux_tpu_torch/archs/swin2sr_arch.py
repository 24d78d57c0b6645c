"""Swin2SR (Conde et al., ECCV 2022 AIM) in PyTorch.

Port of the JAX package's archs/swin2sr_arch.py (its swin2sr_s, swin2sr_m
and swin2sr_l presets): SwinV2 attention (cosine similarity with a learned
per-head temperature, a continuous position bias from an MLP over
log-spaced relative coordinates) in post-norm residual blocks, SwinIR's
body and pixel-shuffle tail. Module names are upstream mv-lab Swin2SR's, so
`state_dict()` has its keys (`layers.{i}.residual_group.blocks.{j}.attn.
cpb_mlp.0.weight`, `...attn.logit_scale`, `patch_embed.norm.weight`, ...),
with one exception kept from the JAX package: the qkv Linear carries one
bias of 3C entries that all train, where upstream keeps `q_bias` and
`v_bias` and fixes the k bias at 0 (`SRModel.load_network` packs an
upstream pair as [q, 0, v], as the JAX converter does).

Swin2Block has two branches, chosen as in the JAX package:

- kernels (default): `fused_cos_attn_block` then `fused_postnorm_mlp`
  (TPU kernels #11-#14 on the card, both ways); the CPB bias MLP, 16 *
  sigmoid, the shift masks and exp(min(logit_scale, log 100)) stay outside
  them in PyTorch, so autograd carries their gradients from the kernels'
  dbias and dscale;
- unfused (`TRAINNER_FUSED_BLOCK=0` or `TRAINNER_FUSED_ATTN=0`, and any
  block whose kernel plans do not fit one thread block, as Swin2SR-L's in
  training): window partition, cosine attention with the per-window mask,
  LayerNorms and the MLP in PyTorch, no kernel.

On the CPU the kernel wrappers run their plain versions, so both branches
run anywhere. The network takes and returns NCHW images; the body runs on
NHWC tokens. DropPath draws from the `generator` attribute of each
Swin2Block, which the model sets (`set_dropout_generator`). Every LayerNorm,
`patch_embed.norm` included, has eps 1e-5.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import Conv2d
from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
    Mlp,
    PatchEmbedNorm,
    ResidualGroup,
    _attn_mask,
    _conv_nhwc,
    _relative_position_index,
    init_transformer_weights,
    window_partition,
    window_reverse,
)
from trainner_redux_tpu_torch.ops.fused_block_v2 import (
    fused_block_v2_supported,
    fused_cos_attn_block,
    fused_postnorm_mlp,
)
from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.utils.registry import SPANDREL_REGISTRY

LOGIT_MAX = math.log(1.0 / 0.01)  # the clamp of logit_scale: a temperature of at most 100


@lru_cache(maxsize=16)
def _log_coords(ws: int) -> np.ndarray:
    """((2w-1)^2, 2) log-spaced relative coordinates for the CPB MLP."""
    rh = np.arange(-(ws - 1), ws, dtype=np.float64)
    rw = np.arange(-(ws - 1), ws, dtype=np.float64)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1).reshape(-1, 2)
    table = table / (ws - 1) * 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


class SwinV2Attention(nn.Module):
    """Cosine window attention of SwinV2 over (B*nW, n, C) windows."""

    def __init__(self, dim: int, window_size: int, num_heads: int) -> None:
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((num_heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_coords_table",
                             torch.from_numpy(_log_coords(window_size)), persistent=False)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(window_size)),
                             persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(nh, n, n) continuous position bias, 16 * sigmoid of the CPB MLP."""
        n = self.window_size**2
        table = self.cpb_mlp(self.relative_coords_table)
        bias = table[self.relative_position_index.reshape(-1)].reshape(n, n, self.num_heads)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def scale(self) -> torch.Tensor:
        """(nh, 1, 1) temperatures exp(min(logit_scale, log 100)); torch.minimum
        splits the gradient at a tie, as jnp.minimum does."""
        cap = torch.tensor(LOGIT_MAX, device=self.logit_scale.device)
        return torch.exp(torch.minimum(self.logit_scale, cap))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """Plain attention over windows x (B*nW, n, C); mask (nW, n, n)."""
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (b_, nh, n, hd)
        qn = q / torch.sqrt((q * q).sum(-1, keepdim=True)).clamp_min(1e-12)
        kn = k / torch.sqrt((k * k).sum(-1, keepdim=True)).clamp_min(1e-12)
        attn = (qn @ kn.transpose(-2, -1)) * self.scale()[None] + self.position_bias()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class Swin2Block(nn.Module):
    """Post-norm SwinV2 block on NHWC x: z = x + DropPath(LN1(attn(x))),
    out = z + DropPath(LN2(mlp(z)))."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 2.0, drop_path: float = 0.0) -> None:
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        self.attn = SwinV2Attention(dim, window_size, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        kinds = shift_mask_kinds(window_size, shift_size) if shift_size > 0 else None
        self.register_buffer(
            "mask_kinds", None if kinds is None else torch.from_numpy(kinds), persistent=False
        )
        self.generator: torch.Generator | None = None  # DropPath masks; see the module doc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        s1 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        s2 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        attn, mlp = self.attn, self.mlp
        if fused_block_v2_supported(h, w, ws, c, self.num_heads, mlp.fc1.out_features,
                                    self.training):
            bias = attn.position_bias()[None]
            if shift > 0:
                bias = bias + self.mask_kinds[:, None]
            z = fused_cos_attn_block(
                x.contiguous(), attn.qkv.weight.t().contiguous(), attn.qkv.bias,
                attn.scale().reshape(-1), attn.proj.weight.t().contiguous(), attn.proj.bias,
                self.norm1.weight, self.norm1.bias, bias.contiguous(), s1, self.num_heads,
                attn.head_dim, ws, 1e-5, shift=shift,
            )
            return fused_postnorm_mlp(
                z, mlp.fc1.weight.t().contiguous(), mlp.fc1.bias,
                mlp.fc2.weight.t().contiguous(), mlp.fc2.bias, self.norm2.weight,
                self.norm2.bias, s2, ws, 1e-5,
            )

        y = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x
        mask = _attn_mask(h, w, ws, shift)
        if mask is not None:
            mask = torch.from_numpy(mask).to(x.device)
        y = window_reverse(attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + s1[:, None, None, None] * self.norm1(y)
        return (x + s2[:, None, None, None] * self.norm2(mlp(x))).contiguous()


class RSTB(nn.Module):
    """Residual group of Swin2Blocks (shift 0 on even blocks, ws/2 on odd
    ones), a 3x3 conv, a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop_paths: list[float]) -> None:
        super().__init__()
        self.residual_group = ResidualGroup([
            Swin2Block(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                       mlp_ratio, drop_paths[i])
            for i in range(depth)
        ])
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.residual_group(x)) + x


class Swin2SR(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 180,
                 depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, drop_path_rate: float = 0.1, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", num_feat: int = 64) -> None:
        super().__init__()
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.upsampler = upsampler
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        self.conv_first = Conv2d(in_chans, embed_dim, 3)
        self.patch_embed = PatchEmbedNorm(embed_dim, eps=1e-5)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = nn.ModuleList()
        cursor = 0
        for depth, heads in zip(depths, num_heads):
            self.layers.append(RSTB(embed_dim, depth, heads, window_size, mlp_ratio,
                                    dpr[cursor : cursor + depth]))
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

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every Swin2Block draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, Swin2Block):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> Swin2SR:
        """Linear weights (the CPB MLP's too) trunc-normal 0.02, zero biases,
        LayerNorm ones and zeros, torch's default conv init, from
        `generator`; logit_scale keeps log 10, as upstream."""
        return init_transformer_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale)."""
        in_h, in_w = x.shape[2], x.shape[3]
        if x.shape[1] == 3:
            x = (x - self.mean) * self.img_range
        ws = self.window_size
        ph, pw = (ws - in_h % ws) % ws, (ws - in_w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")

        feat = self.conv_first(x)
        body = self.patch_embed.norm(feat.permute(0, 2, 3, 1).contiguous())  # NHWC tokens
        for layer in self.layers:
            body = layer(body)
        body = self.norm(body)
        feat = feat + self.conv_after_body(body.permute(0, 3, 1, 2))
        out = self.conv_last(self.upsample(self.conv_before_upsample(feat)))
        if out.shape[1] == 3:
            out = out / self.img_range + self.mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _swin2sr_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs, as the JAX factory drops them
        for k in ("img_size", "patch_size", "in_chans", "ape", "patch_norm", "use_checkpoint",
                  "drop_rate", "attn_drop_rate", "qkv_bias", "qk_scale", "resi_connection",
                  "dtype"):
            kwargs.pop(k, None)
        cfg.update(kwargs)
        cfg["depths"] = tuple(cfg["depths"])
        cfg["num_heads"] = tuple(cfg["num_heads"])
        return Swin2SR(upscale=scale, **cfg)

    return factory


swin2sr_m = SPANDREL_REGISTRY.register(
    _swin2sr_factory(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8),
    name="swin2sr_m",
)
swin2sr_s = SPANDREL_REGISTRY.register(
    _swin2sr_factory(embed_dim=60, depths=[6] * 4, num_heads=[6] * 4, window_size=8),
    name="swin2sr_s",
)
swin2sr_l = SPANDREL_REGISTRY.register(
    _swin2sr_factory(embed_dim=240, depths=[6] * 9, num_heads=[8] * 9, window_size=8),
    name="swin2sr_l",
)
