"""SRFormer (permuted self-attention) in PyTorch.

Port of the JAX package's archs/srformer_arch.py (upstream SRFormer v1 and
its srformer and srformer_light presets), with upstream's module names, so
`state_dict()` has the official torch keys
(`layers.{i}.residual_group.blocks.{j}.attn.kv.weight`,
`...attn.relative_position_bias_table`, `...mlp.fc1.weight`,
`patch_embed.norm.weight`, ...) and an upstream checkpoint loads with
`strict=True` once its recomputable buffers (`relative_position_index`,
`aligned_relative_position_index`, `attn_mask`) are dropped.

The SwinIR skeleton with PSA in each block:

- PSA (`PSAttention`): windows of ws x ws tokens; q at full resolution, k
  and v from one Linear of C / 2 channels whose r x r (r = 2) groups of
  tokens fold into one token of C channels, so a window's queries see
  (ws / 2)^2 keys; the aligned relative-position bias (`_psa_rel_index`,
  permuted tokens at the centres of their 2x2 groups, rounded half to even
  as numpy rounds); a shifted block (shift ws / 2, where min(H, W) > ws)
  adds the standard shift mask with its key side subsampled at the groups'
  first tokens. Plain PyTorch, as the JAX package computes it outside any
  kernel.
- The pre-LN MLP half goes through `fused_mlp_residual` (TPU kernels #2
  and #7 on the card) with rows = ws: C 180 / hidden 360 at ws 24 for
  `srformer`, C 60 / hidden 120 at ws 16 for `srformer_light`; its plain
  branch is the modules.

DropPath (rate linspace(0, 0.1) over the blocks, both halves) draws from
the `generator` attribute of each block, which the model sets
(`set_dropout_generator`). The input is reflect-padded to a multiple of the
window and the output cropped; `patch_embed.norm` (eps 1e-5) acts on the
body branch only, the conv_first residual stays un-normed. Every LayerNorm
uses eps 1e-5 and GELU is exact.

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32; a
training forward in bf16 computes as the flax SRFormer does with
`dtype=bfloat16`: the input and the mean cast to bf16, every convolution,
Linear and LayerNorm through `arch_util.in_dtype`, PSA's scores summed in
fp32 from bf16(q * bf16(hd^-0.5)) (`arch_util.scale_by`: flax's weak-typed
scale) and k, the softmax in fp32 rounded to bf16 before its product with v,
the MLP halves on the bf16 forms of #2/#7, the LeakyReLU slope rounded to
bf16; the output back to fp32. An eval forward runs in fp32 (the fp32 twin).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    Conv2d,
    LeakyReLU,
    droppath,
    in_dtype,
    parse_dtype,
    scale_by,
)
from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale, fused_mlp_residual
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
    Mlp,
    PatchEmbedNorm,
    ResidualGroup,
    _attn_mask,
    _conv_nhwc,
    init_transformer_weights,
    window_partition,
    window_reverse,
)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY


@lru_cache(maxsize=32)
def _psa_rel_index(ws: int, pws: int) -> np.ndarray:
    """(ws^2, pws^2) aligned relative-position index into the (2 ws - 1)^2
    table: permuted tokens sit at the centres of their r x r groups."""
    r = ws // pws
    coords_q = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    coords_k = (
        np.stack(np.meshgrid(np.arange(pws), np.arange(pws), indexing="ij")).reshape(2, -1) * r
        + (r - 1) / 2
    )
    rel = coords_q[:, :, None] - coords_k[:, None, :]
    rel = np.round(rel + (ws - 1)).astype(np.int64)  # half to even, as the JAX package
    return rel[0] * (2 * ws - 1) + rel[1]


@lru_cache(maxsize=64)
def _psa_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray | None:
    """(nW, ws^2, (ws / 2)^2) shift mask of the permuted keys: the standard
    mask's key side at the first token of each 2x2 group, or None."""
    mask = _attn_mask(h, w, ws, shift)
    if mask is None:
        return None
    pws = ws // 2
    return np.ascontiguousarray(
        mask.reshape(-1, ws * ws, pws, 2, pws, 2)[:, :, :, 0, :, 0].reshape(-1, ws * ws, pws * pws))


class PSAttention(nn.Module):
    """Permuted self-attention over windows (B*nW, ws^2, C)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True) -> None:
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, dim // 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "aligned_relative_position_index",
            torch.from_numpy(_psa_rel_index(window_size, window_size // 2)), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        b_, n, c = x.shape
        pws, nh, hd = self.window_size // 2, self.num_heads, self.head_dim
        np_tok = pws * pws
        q = in_dtype(self.q, x).reshape(b_, n, nh, hd).transpose(1, 2)
        # each 2x2 group of tokens -> one token of (dy, dx, C / 4) channels
        kv = in_dtype(self.kv, x).reshape(b_, pws, 2, pws, 2, 2, c // 4)
        kv = kv.permute(0, 1, 3, 5, 2, 4, 6).reshape(b_, np_tok, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]  # (b_, nh, np_tok, hd)
        # in x's dtype, as flax's: bf16(q bf16(scale)) k summed in fp32, the
        # softmax in fp32 rounded to bf16 before its product with v
        attn = scale_by(q, hd**-0.5).float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[self.aligned_relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, np_tok, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, np_tok) + mask[None, :, None]
            attn = attn.reshape(b_, nh, n, np_tok)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return in_dtype(self.proj, out)


class SRFormerBlock(nn.Module):
    """x + DropPath(PSA(LN1 x)), then the pre-LN MLP half; x is NHWC."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 2.0, drop_path: float = 0.0) -> None:
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = PSAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.generator: torch.Generator | None = None  # DropPath masks; see the module doc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        y = in_dtype(self.norm1, x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = _psa_mask(h, w, ws, shift)
        if mask is not None:
            mask = torch.from_numpy(mask).to(x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        s1 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        x = x + droppath(y, s1)
        fused = fused_mlp_residual(x, self.norm2, self.mlp.fc1, self.mlp.fc2, self.drop_path,
                                   self.training, ws, self.generator)
        if fused is not None:
            return fused
        s2 = droppath_scale(self.drop_path, self.training, b, x.device, self.generator)
        return (x + droppath(self.mlp(in_dtype(self.norm2, x)), s2)).contiguous()


class PSALayer(nn.Module):
    """A residual group of blocks (shift 0 on even blocks, ws / 2 on odd
    ones), a 3x3 conv, a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop_paths: list[float]) -> None:
        super().__init__()
        self.residual_group = ResidualGroup([
            SRFormerBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                          mlp_ratio, drop_paths[i])
            for i in range(depth)
        ])
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.residual_group(x)) + x


class SRFormer(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3, embed_dim: int = 180,
                 depths=(6,) * 6, num_heads=(6,) * 6, window_size: int = 24,
                 mlp_ratio: float = 2.0, drop_path_rate: float = 0.1, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", resi_connection: str = "1conv",
                 num_feat: int = 64, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
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
            self.layers.append(PSALayer(embed_dim, depth, heads, window_size, mlp_ratio,
                                        dpr[cursor : cursor + depth]))
            cursor += depth
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3)
        if upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(Conv2d(embed_dim, in_chans * upscale**2, 3),
                                          nn.PixelShuffle(upscale))
        else:
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
        """Why this network cannot train in bf16 on the port, or None: the MLP
        halves have the bf16 forms of #2/#7 and PSA computes in bf16 in
        PyTorch, so none."""
        return None

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every block draws its DropPath masks from."""
        for m in self.modules():
            if isinstance(m, SRFormerBlock):
                m.generator = generator

    def init_weights(self, generator: torch.Generator) -> SRFormer:
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
        if self.upsampler == "pixelshuffledirect":
            out = in_dtype(self.upsample, feat)
        else:
            out = in_dtype(self.conv_last,
                           in_dtype(self.upsample, in_dtype(self.conv_before_upsample, feat)))
        if out.shape[1] == 3:
            out = out / self.img_range + mean
        return out[:, :, : in_h * self.upscale, : in_w * self.upscale].float()


def _srformer_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs, as the JAX factory drops them
        for k in ("img_size", "patch_size", "in_chans", "ape", "patch_norm", "use_checkpoint",
                  "drop_rate", "attn_drop_rate", "qkv_bias", "qk_scale"):
            kwargs.pop(k, None)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["depths"] = tuple(cfg["depths"])
        cfg["num_heads"] = tuple(cfg["num_heads"])
        return SRFormer(upscale=scale, **cfg)

    return factory


srformer = ARCH_REGISTRY.register(
    _srformer_factory(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=24),
    name="srformer",
)
srformer_light = ARCH_REGISTRY.register(
    _srformer_factory(embed_dim=60, depths=[6] * 4, num_heads=[6] * 4, window_size=16,
                      upsampler="pixelshuffledirect"),
    name="srformer_light",
)
