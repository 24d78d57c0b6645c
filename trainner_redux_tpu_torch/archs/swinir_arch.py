"""SwinIR in PyTorch — shifted-window transformer for image restoration.

Port of the JAX package's archs/swinir_arch.py, with upstream SwinIR's
module names, so `state_dict()` has exactly the official torch keys
(`layers.{i}.residual_group.blocks.{j}.attn.qkv.weight`,
`patch_embed.norm.weight`, ...) and an official checkpoint loads with
`strict=True` once its recomputable buffers are dropped. The relative
position index and the shift-mask kinds are non-persistent buffers.

The network takes and returns NCHW images; the transformer body runs on
NHWC tokens, the layout of the block kernels. SwinBlock has three branches,
chosen as in the JAX package:

- fused (default): in training `fused_swin_block_train`, the whole block
  as one autograd Function with kernels both ways; at eval
  `fused_attn_block` then `fused_ln_mlp`, two forward-only kernels;
- unfused (`TRAINNER_FUSED_BLOCK=0`, and any block outside the fused
  kernels: in training SwinIR-L's C 240, DRCT's 16x16 windows): norm1 and
  the qkv and proj Linears in PyTorch around `fused_window_mhsa`, whose
  kernels run both ways, then the MLP half on `fused_ln_mlp` (#2/#7)
  wherever `fused_mlp_supported` takes it (not under
  `TRAINNER_FUSED_BLOCK=0`), else norm2 and the MLP in PyTorch;
- plain (`TRAINNER_FUSED_ATTN=0`): window partition and PyTorch attention
  with the per-window mask, no kernel at all.

On the CPU the kernel wrappers run their plain versions, so all three
branches run anywhere.

DropPath draws its masks from the `generator` attribute of each SwinBlock,
which the model sets (`set_dropout_generator`); torch's global generator is
never read.

Compute dtype (`compute_dtype`, as the JAX package's `dtype` field and
`build_network_cast` set it): the parameters stay fp32, and a training
forward in bf16 computes as the flax SwinIR does with `dtype=bfloat16`: the
input cast to bf16, every convolution, Linear and LayerNorm through
`arch_util.in_dtype` (bf16 operands, biases added in bf16, LayerNorm
statistics in fp32), each SwinBlock on `fused_swin_block_train`'s bf16 forms
or, off that branch (SwinIR-L), on the bf16 forms of `fused_window_mhsa`
(#3/#8) with its Linears and MLP in bf16; the output back to fp32. The
parameters are cast at use (`w.to(bf16)`), so their gradients arrive in fp32
through the casts; no autocast, whose op lists round elsewhere. An eval
forward (validation, `test`, the EMA network) computes in fp32 from the same
parameters: the JAX package's fp32 twin.

Divergence from upstream SwinIR kept from the JAX package: `patch_embed.norm`
uses eps 1e-6 (flax's LayerNorm default); every other LayerNorm uses 1e-5.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import Conv2d, droppath, in_dtype, parse_dtype
from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale
from trainner_redux_tpu_torch.ops.fused_block import (
    fused_attn_block,
    fused_block_supported,
    fused_ln_mlp,
    fused_mlp_supported,
    fused_swin_block_train,
    swin_block_train_fits,
)
from trainner_redux_tpu_torch.ops.window_attention import (
    fused_window_mhsa,
    fused_window_mhsa_supported,
    shift_mask_kinds,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY

_MEAN = (0.4488, 0.4371, 0.4040)


@lru_cache(maxsize=32)
def _relative_position_index(window_size: int) -> np.ndarray:
    """(win^2, win^2) indices into the (2w-1)^2 bias table (upstream order)."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    relative = coords_flat[:, :, None] - coords_flat[:, None, :]  # 2, n, n
    relative = relative.transpose(1, 2, 0).astype(np.int64)
    relative[:, :, 0] += ws - 1
    relative[:, :, 1] += ws - 1
    relative[:, :, 0] *= 2 * ws - 1
    return relative.sum(-1)


@lru_cache(maxsize=64)
def _attn_mask(hp: int, wp: int, window_size: int, shift: int) -> np.ndarray | None:
    """Per-window attention mask for shifted windows: (nW, win^2, win^2) with
    0 / -100 entries, or None when no shift."""
    if shift == 0:
        return None
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for h in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
        for w in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    mask = img_mask.reshape(hp // window_size, window_size, wp // window_size, window_size)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = mask[:, None, :] - mask[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B,H,W,C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None) -> None:
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = qk_scale or self.head_dim**-0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)),
            persistent=False,
        )
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def position_bias(self) -> torch.Tensor:
        """(nh, n, n) relative-position bias."""
        n = self.window_size**2
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """Plain attention over windows x (B*nW, n, C); mask (nW, n, n). In
        x's dtype, as flax's: for bf16 x the scores sum bf16(q scale) k in
        fp32 and the softmax is fp32, rounded to bf16 before its product with
        v."""
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = in_dtype(self.qkv, x).reshape(b_, n, 3, nh, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (b_, nh, n, hd)
        attn = (q * self.scale).float() @ k.float().transpose(-2, -1) + self.position_bias()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return in_dtype(self.proj, out)


def bias_kinds(attn: WindowAttention, mask_kinds: torch.Tensor | None,
               shift: int) -> torch.Tensor:
    """(K, nh, n, n) kind table of `attn`'s relative-position bias: K=4 with
    the shift masks (kind, n, n) added, else K=1."""
    bias = attn.position_bias()
    if shift > 0:
        return (bias[None] + mask_kinds[:, None]).contiguous()
    return bias[None].contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(self.fc2, F.gelu(in_dtype(self.fc1, x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_path: float = 0.0) -> None:
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.qk_scale = qk_scale
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        kinds = shift_mask_kinds(window_size, shift_size) if shift_size > 0 else None
        self.register_buffer(
            "mask_kinds", None if kinds is None else torch.from_numpy(kinds), persistent=False
        )
        self.generator: torch.Generator | None = None  # DropPath masks; see the module doc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, H, W, C) contiguous; H, W multiples of window_size
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        hidden = self.mlp.fc1.out_features
        s1 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        s2 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)

        fused = self.qk_scale is None and fused_block_supported(
            h, w, ws, c, self.num_heads, hidden)
        if fused and self.training:
            # a block too large for the training kernels trains on the
            # unfused branch, which computes the same function
            fused = swin_block_train_fits(h, w, ws, c, self.num_heads, hidden)
        if fused:
            # the kernels take (in, out) weights; the attention kernels read
            # the rolled windows and write their outputs unrolled
            bias = bias_kinds(self.attn, self.mask_kinds, shift)
            if self.training:
                return fused_swin_block_train(
                    x.contiguous(), self.norm1.weight, self.norm1.bias,
                    self.attn.qkv.weight.t().contiguous(), _bias_or_zeros(self.attn.qkv),
                    self.attn.proj.weight.t().contiguous(), self.attn.proj.bias,
                    bias, self.norm2.weight, self.norm2.bias,
                    self.mlp.fc1.weight.t().contiguous(), self.mlp.fc1.bias,
                    self.mlp.fc2.weight.t().contiguous(), self.mlp.fc2.bias, s1, s2,
                    self.num_heads, self.attn.head_dim, ws, 1e-5, shift=shift,
                )
            z = fused_attn_block(
                x.contiguous(), self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight.t().contiguous(), _bias_or_zeros(self.attn.qkv),
                self.attn.proj.weight.t().contiguous(), self.attn.proj.bias,
                bias, s1, self.num_heads, self.attn.head_dim, ws, 1e-5,
                shift=shift,
            )
            return fused_ln_mlp(
                z, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.t().contiguous(),
                self.mlp.fc1.bias, self.mlp.fc2.weight.t().contiguous(), self.mlp.fc2.bias,
                s2, ws, 1e-5,
            )

        # unfused and plain, in x's dtype (bf16: #3/#8's bf16 forms)
        shortcut = x
        x = in_dtype(self.norm1, x)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        if self.qk_scale is None and fused_window_mhsa_supported(h, w, ws, c, self.num_heads):
            qkv = in_dtype(self.attn.qkv, x).contiguous()
            out = fused_window_mhsa(qkv, bias_kinds(self.attn, self.mask_kinds, shift),
                                    self.num_heads, self.attn.head_dim, ws)
            x = in_dtype(self.attn.proj, out)
        else:
            mask = _attn_mask(h, w, ws, shift)
            if mask is not None:
                mask = torch.from_numpy(mask).to(x.device)
            x = window_reverse(self.attn(window_partition(x, ws), mask), ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + droppath(x, s1)
        if fused_mlp_supported(h, w, ws, c, hidden, self.training):
            # the MLP half on #2/#7, with the s2 drawn above
            return fused_ln_mlp(
                x.contiguous(), self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight.t().contiguous(), self.mlp.fc1.bias,
                self.mlp.fc2.weight.t().contiguous(), self.mlp.fc2.bias, s2, ws, 1e-5,
            )
        y = self.mlp(in_dtype(self.norm2, x))
        return (x + droppath(y, s2)).contiguous()


def _bias_or_zeros(linear: nn.Linear) -> torch.Tensor:
    if linear.bias is not None:
        return linear.bias
    return torch.zeros(linear.out_features, device=linear.weight.device)


class ResidualGroup(nn.Module):
    """Blocks applied in order (SwinIR's SwinBlocks, Swin2SR's Swin2Blocks)."""

    def __init__(self, blocks: list[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to NHWC x in x's dtype, returning contiguous
    NHWC. The permuted view is NCHW in channels-last memory, which cuDNN
    keeps."""
    return in_dtype(conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def _resi_conv(dim: int, resi_connection: str) -> nn.Module:
    if resi_connection == "1conv":
        return Conv2d(dim, dim, 3)
    # 3conv bottleneck
    return nn.Sequential(
        Conv2d(dim, dim // 4, 3), nn.LeakyReLU(0.2),
        Conv2d(dim // 4, dim // 4, 1), nn.LeakyReLU(0.2),
        Conv2d(dim // 4, dim, 3),
    )


class RSTB(nn.Module):
    """Residual Swin Transformer Block (a residual group + conv)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: float | None,
                 drop_paths: list[float], resi_connection: str = "1conv") -> None:
        super().__init__()
        self.residual_group = ResidualGroup([
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio, qkv_bias, qk_scale, drop_paths[i])
            for i in range(depth)
        ])
        self.conv = _resi_conv(dim, resi_connection)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.residual_group(x)) + x


class PatchEmbedNorm(nn.Module):
    """Holds upstream's `patch_embed.norm` (the patch embedding itself is a
    flatten, which NHWC tokens make free)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps)


class SwinIR(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", resi_connection: str = "1conv",
                 start_unshuffle: int = 1, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.upscale = upscale
        self.in_chans = in_chans
        self.window_size = window_size
        self.img_range = img_range
        self.upsampler = upsampler
        self.start_unshuffle = start_unshuffle
        self.patch_norm = patch_norm
        self.register_buffer(
            "mean", torch.tensor(_MEAN, dtype=torch.float32).view(1, 3, 1, 1), persistent=False
        )
        in_ch = in_chans * start_unshuffle**2
        effective_scale = upscale * start_unshuffle

        self.conv_first = Conv2d(in_ch, embed_dim, 3)
        if patch_norm:
            self.patch_embed = PatchEmbedNorm(embed_dim)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = nn.ModuleList()
        cursor = 0
        for depth, heads in zip(depths, num_heads):
            self.layers.append(RSTB(
                embed_dim, depth, heads, window_size, mlp_ratio, qkv_bias, qk_scale,
                dpr[cursor : cursor + depth], resi_connection,
            ))
            cursor += depth
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = _resi_conv(embed_dim, resi_connection)

        out_ch = in_chans
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(Conv2d(embed_dim, 64, 3), nn.LeakyReLU(0.01))
            stages: list[nn.Module] = []
            s = effective_scale
            while s > 1:
                f = 3 if s % 3 == 0 else 2
                stages += [Conv2d(64, 64 * f * f, 3), nn.PixelShuffle(f)]
                s //= f
            self.upsample = nn.Sequential(*stages)
            self.conv_last = Conv2d(64, out_ch, 3)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                Conv2d(embed_dim, out_ch * effective_scale**2, 3),
                nn.PixelShuffle(effective_scale),
            )
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(Conv2d(embed_dim, 64, 3), nn.LeakyReLU(0.01))
            s, stage = effective_scale, 1
            while s > 1:
                self.add_module(f"conv_up{stage}", Conv2d(64, 64, 3))
                s //= 2
                stage += 1
            self.num_up = stage - 1
            self.conv_hr = Conv2d(64, 64, 3)
            self.conv_last = Conv2d(64, out_ch, 3)
        else:  # '' — restoration (scale 1)
            self.conv_last = Conv2d(embed_dim, out_ch, 3)

    def bf16_refusal(self) -> str | None:
        """Why this network cannot train in bf16 on the port, or None: every
        SwinBlock branch has its bf16 form (the fused training branch #4/#5,
        the unfused branch #3/#8, the plain branch in PyTorch), so none."""
        return None

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every SwinBlock draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, SwinBlock):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> SwinIR:
        return init_transformer_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> (B, C, H*scale, W*scale), fp32; in
        training computed in `compute_dtype`, at eval in fp32."""
        in_h, in_w = x.shape[2], x.shape[3]
        x = x.to(self.compute_dtype if self.training else torch.float32)
        if self.start_unshuffle > 1:
            x = F.pixel_unshuffle(x, self.start_unshuffle)
        mean = self.mean.to(x.dtype)
        # mean-shift and scale 3-channel input, as upstream SwinIR
        three = x.shape[1] == 3
        if three:
            x = (x - mean) * self.img_range

        # pad to a window multiple (reflect, like check_image_size)
        h, w = x.shape[2], x.shape[3]
        ws = self.window_size
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")

        feat = in_dtype(self.conv_first, x)
        body = feat.permute(0, 2, 3, 1).contiguous()  # NHWC tokens
        if self.patch_norm:
            body = in_dtype(self.patch_embed.norm, body)
        for layer in self.layers:
            body = layer(body)
        body = in_dtype(self.norm, body)
        feat = feat + in_dtype(self.conv_after_body, body.permute(0, 3, 1, 2))

        if self.upsampler == "pixelshuffle":
            feat = in_dtype(self.conv_before_upsample, feat)
            out = in_dtype(self.conv_last, in_dtype(self.upsample, feat))
        elif self.upsampler == "pixelshuffledirect":
            out = in_dtype(self.upsample, feat)
        elif self.upsampler == "nearest+conv":
            feat = in_dtype(self.conv_before_upsample, feat)
            for stage in range(1, self.num_up + 1):
                feat = F.interpolate(feat, scale_factor=2, mode="nearest")
                feat = F.leaky_relu(in_dtype(getattr(self, f"conv_up{stage}"), feat), 0.2)
            out = in_dtype(self.conv_last, F.leaky_relu(in_dtype(self.conv_hr, feat), 0.2))
        else:
            out = in_dtype(self.conv_last, feat)

        if out.shape[1] == 3:
            out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


@torch.no_grad()
def init_transformer_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `net` from `generator` with upstream SwinIR's
    and HAT's scheme (Linear weights and relative-position bias tables
    trunc-normal 0.02, zero Linear biases, LayerNorm ones and zeros) and
    torch's default conv init; returns `net`."""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        if isinstance(getattr(m, "relative_position_bias_table", None), nn.Parameter):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, generator=generator)
    return net


def _swinir_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs
        for k in ("img_size", "patch_size", "ape", "use_checkpoint", "drop_rate",
                  "attn_drop_rate", "in_chans"):
            kwargs.pop(k, None)
        # the JAX package's compute dtype (build_network_cast)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["depths"] = tuple(cfg["depths"])
        cfg["num_heads"] = tuple(cfg["num_heads"])
        return SwinIR(upscale=scale, **cfg)

    return factory


swinir_l = ARCH_REGISTRY.register(
    _swinir_factory(
        embed_dim=240, depths=[6] * 9, num_heads=[8] * 9, window_size=8,
        upsampler="nearest+conv", resi_connection="3conv",
    ),
    name="swinir_l",
)
swinir_m = ARCH_REGISTRY.register(
    _swinir_factory(
        embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
        upsampler="pixelshuffle", resi_connection="1conv",
    ),
    name="swinir_m",
)
swinir_s = ARCH_REGISTRY.register(
    _swinir_factory(
        embed_dim=60, depths=[6] * 4, num_heads=[6] * 4, window_size=8,
        upsampler="pixelshuffledirect", resi_connection="1conv",
    ),
    name="swinir_s",
)
