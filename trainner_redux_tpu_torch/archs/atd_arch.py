"""ATD (Adaptive Token Dictionary) in PyTorch.

Port of the JAX package's archs/atd_arch.py (upstream ATD and its atd and
atd_light presets). Each layer sums three attentions of one LayerNorm
output, then a ConvFFN, and refreshes the group's token dictionary:

- `attn_win`: SwinIR's window attention (16x16 windows, shift ws / 2 on odd
  layers where min(H, W) > ws) through `fused_window_mhsa` (TPU kernels #3
  and #8 on the card) with the bias-kind table and the caller's roll when
  `fused_window_mhsa_supported` says so: `atd`'s heads of 35 take the
  kernels' 64-wide form, `atd_light`'s heads of 8 the 32-wide one. Else
  window partition, the per-window mask and PyTorch attention.
- `attn_atd` (`ATDCrossAttention`): each token against the dictionary's
  tokens, q and k L2-normalised (clamp 1e-12) in `reducted_dim` channels
  and scaled by exp(scale); `sim` is the fp32 softmax.
- `attn_aca` (`AdaptiveCategoryMSA`): the tokens sorted stably by their
  category (the argmax of `sim`), cut into groups of `category_size`, the
  last padded with zero tokens whose keys get -1e9, MSA in each group, and
  the inverse order back. Both reorderings are `permute_tokens`, a gather
  whose backward is the gather by the inverse permutation: no scatter-add,
  so a backward is bit-identical run to run on the card.
- `ConvFFN`: fc1, exact GELU, a depthwise conv (k 5 for `atd`, 7 for
  `atd_light`) added to its own input, fc2.
- The dictionary refresh: sigmoid(sigma) td + (1 - sigmoid(sigma)) times
  the sim-weighted pooling of the layer's output, td tiled per sample in
  the compute dtype.

As in the JAX package, `attn_win.qkv` and `attn_aca.qkv` are two Linears,
initialised apart (upstream shares one `wqkv`; `utils.torch_compat.
canonical_atd_keys` copies it into both), the layer has no `norm3`, and
there is no DropPath and no patch norm. The state dict's keys are the JAX
package's `_export_atd` layout with the two qkv Linears named apart
(`layers.{g}.layers.{j}.attn_win.qkv.weight`, `layers.{g}.td`,
`...convffn.dwconv.weight`, ...). The network takes and returns NCHW
images; the body runs on NHWC tokens. Reflect-padded to a multiple of the
window, the output cropped.

Compute dtype (`compute_dtype`, as SwinIR's): the parameters stay fp32; a
training forward in bf16 computes as the flax ATD does with
`dtype=bfloat16`: every convolution, Linear and LayerNorm through
`arch_util.in_dtype`, the window attention on the bf16 forms of #3/#8, the
score products summed in fp32 from bf16 operands, the softmaxes in fp32
rounded to bf16 before their products, the dictionary in bf16; the output
back to fp32. An eval forward runs in fp32 (the fp32 twin).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from trainner_redux_tpu_torch.archs.arch_util import (
    Conv2d,
    LeakyReLU,
    in_dtype,
    parse_dtype,
    scale_by,
)
from trainner_redux_tpu_torch.archs.swinir_arch import (
    _MEAN,
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


class _PermuteTokens(torch.autograd.Function):
    """x[b, order[b, i]] along dim 1; the backward gathers the gradient by
    the inverse permutation `inv` (a permutation's transpose is its
    inverse), so it adds nothing and needs no scatter."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv, order)
        return x.gather(1, order[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        inv, order = ctx.saved_tensors
        return _PermuteTokens.apply(grad.contiguous(), inv, order), None, None


def permute_tokens(x: torch.Tensor, order: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x with its tokens in `order` (B, N), a permutation whose
    inverse is `inv`; differentiable in x by the gather by `inv`."""
    return _PermuteTokens.apply(x, order, inv)


def sort_by_category(category: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse order) of the tokens (B, N) by their category: the
    stable sort (as jnp.argsort) and the inverse permutation."""
    order = torch.argsort(category, dim=-1, stable=True)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return order, inv


def category_order(sim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(category, order, inverse order) of the tokens from sim (B, N, M):
    the argmax category (the first of equal maxima, as jnp.argmax), then
    `sort_by_category`."""
    category = sim.argmax(dim=-1)
    return category, *sort_by_category(category)


class ATDCrossAttention(nn.Module):
    """Token-dictionary cross attention; returns (out, sim)."""

    def __init__(self, dim: int, num_tokens: int, reducted_dim: int) -> None:
        super().__init__()
        self.wq = nn.Linear(dim, reducted_dim)
        self.wk = nn.Linear(dim, reducted_dim)
        self.wv = nn.Linear(dim, dim)
        self.scale = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, td: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        q, k, v = in_dtype(self.wq, x), in_dtype(self.wk, td), in_dtype(self.wv, td)
        qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
        kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
        logits = (qn.float() @ kn.float().transpose(-2, -1)) * torch.exp(self.scale)
        sim = torch.softmax(logits, dim=-1)
        return sim.to(v.dtype) @ v, sim


class AdaptiveCategoryMSA(nn.Module):
    """MSA within groups of `category_size` tokens of the category-sorted
    sequence (the last group padded, its padded keys masked)."""

    def __init__(self, dim: int, num_heads: int, category_size: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.category_size = category_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, sim: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        cs = min(self.category_size, n)
        nh = self.num_heads
        hd = c // nh
        pad = (cs - n % cs) % cs
        groups = (n + pad) // cs
        _, order, inv = category_order(sim)
        qkv = permute_tokens(in_dtype(self.qkv, x), order, inv)
        if pad:
            qkv = F.pad(qkv, (0, 0, 0, pad))
        q, k, v = qkv.reshape(b * groups, cs, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = scale_by(q, hd**-0.5).float() @ k.float().transpose(-2, -1)
        if pad:  # the padded keys, all in the last group
            valid = torch.arange(n + pad, device=x.device).reshape(groups, 1, 1, cs) < n
            attn = (attn.reshape(b, groups, nh, cs, cs)
                    + torch.where(valid, 0.0, -1e9)[None]).reshape(b * groups, nh, cs, cs)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n + pad, c)[:, :n]
        return in_dtype(self.proj, permute_tokens(out.contiguous(), inv, order))


class ConvFFN(nn.Module):
    """fc1, exact GELU, plus a depthwise conv of itself, fc2; on (B, N, C)."""

    def __init__(self, dim: int, hidden: int, kernel_size: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, kernel_size, 1, kernel_size // 2, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, _ = x.shape
        y = F.gelu(in_dtype(self.fc1, x), approximate="none")
        y = y + _conv_nhwc(self.dwconv, y.reshape(b, h, w, -1)).reshape(b, n, -1)
        return in_dtype(self.fc2, y)


class ATDLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 num_tokens: int, reducted_dim: int, category_size: int, mlp_ratio: float,
                 convffn_kernel_size: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn_win = WindowAttention(dim, window_size, num_heads)
        self.attn_atd = ATDCrossAttention(dim, num_tokens, reducted_dim)
        self.attn_aca = AdaptiveCategoryMSA(dim, num_heads, category_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.convffn = ConvFFN(dim, int(dim * mlp_ratio), convffn_kernel_size)
        self.sigma = nn.Parameter(torch.zeros(num_tokens, 1))
        kinds = shift_mask_kinds(window_size, shift_size) if shift_size > 0 else None
        self.register_buffer(
            "mask_kinds", None if kinds is None else torch.from_numpy(kinds), persistent=False
        )

    def forward(self, x: torch.Tensor, td: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) NHWC, td (B, M, C) -> (x, the refreshed td)."""
        b, h, w, c = x.shape
        n, ws, nh = h * w, self.window_size, self.num_heads
        shift = self.shift_size if min(h, w) > ws else 0
        xn = in_dtype(self.norm1, x)
        xs = torch.roll(xn, (-shift, -shift), dims=(1, 2)) if shift else xn
        attn = self.attn_win
        if fused_window_mhsa_supported(h, w, ws, c, nh):
            qkv = in_dtype(attn.qkv, xs).contiguous()
            out = fused_window_mhsa(qkv, bias_kinds(attn, self.mask_kinds, shift), nh,
                                    attn.head_dim, ws)
            x_win = in_dtype(attn.proj, out)
        else:
            mask = _attn_mask(h, w, ws, shift)
            if mask is not None:
                mask = torch.from_numpy(mask).to(x.device)
            x_win = window_reverse(attn(window_partition(xs, ws), mask), ws, h, w)
        if shift:
            x_win = torch.roll(x_win, (shift, shift), dims=(1, 2))
        xn_seq = xn.reshape(b, n, c)
        x_atd, sim = self.attn_atd(xn_seq, td)
        x_aca = self.attn_aca(xn_seq, sim)
        x = x + x_win + (x_atd + x_aca).reshape(b, h, w, c)
        y = self.convffn(in_dtype(self.norm2, x).reshape(b, n, c), h, w)
        x = x + y.reshape(b, h, w, c)
        # the dictionary refresh: a sigma-gated blend of the old dictionary
        # and the sim-weighted (per dictionary token normalised) pooling
        weights = sim / sim.sum(dim=1, keepdim=True).clamp_min(1e-8)
        pooled = weights.to(x.dtype).transpose(1, 2) @ x.reshape(b, n, c)
        gate = torch.sigmoid(self.sigma).to(td.dtype)
        return x.contiguous(), gate * td + (1.0 - gate) * pooled


class ATDGroup(nn.Module):
    """The group's token dictionary `td`, its layers (shift 0 on even
    layers, ws / 2 on odd ones), a 3x3 conv and a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, num_tokens: int,
                 reducted_dim: int, category_size: int, mlp_ratio: float,
                 convffn_kernel_size: int) -> None:
        super().__init__()
        self.td = nn.Parameter(torch.zeros(num_tokens, dim))
        nn.init.trunc_normal_(self.td, std=0.02)
        self.layers = nn.ModuleList([
            ATDLayer(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                     num_tokens, reducted_dim, category_size, mlp_ratio, convffn_kernel_size)
            for i in range(depth)
        ])
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        td = self.td[None].to(x.dtype).expand(x.shape[0], -1, -1)
        res = x
        for layer in self.layers:
            x, td = layer(x, td)
        return _conv_nhwc(self.conv, x) + res


class ATD(nn.Module):
    def __init__(self, upscale: int = 4, embed_dim: int = 210, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size: int = 16, category_size: int = 256,
                 num_tokens: int = 128, reducted_dim: int = 20, convffn_kernel_size: int = 5,
                 mlp_ratio: float = 2.0, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", num_feat: int = 64,
                 compute_dtype: torch.dtype = torch.float32) -> None:
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
        self.conv_first = Conv2d(3, embed_dim, 3)
        self.layers = nn.ModuleList([
            ATDGroup(embed_dim, depth, heads, window_size, num_tokens, reducted_dim,
                     category_size, mlp_ratio, convffn_kernel_size)
            for depth, heads in zip(depths, num_heads)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3)
        if upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(Conv2d(embed_dim, 3 * upscale**2, 3),
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
            self.conv_last = Conv2d(num_feat, 3, 3)

    def bf16_refusal(self) -> str | None:
        """Why this network cannot train in bf16 on the port, or None: the
        window attention has the bf16 forms of #3/#8 at heads of up to 64
        channels, and the other branches compute in PyTorch, so none."""
        return None

    def init_weights(self, generator: torch.Generator) -> ATD:
        """The transformer scheme (Linear weights and bias tables trunc-normal
        0.02, zero Linear biases, LayerNorm ones and zeros, torch's default
        conv init), the dictionaries trunc-normal 0.02, sigma and the cross
        attention's scale zeros (the JAX package's initialisers), from
        `generator`."""
        init_transformer_weights(self, generator)
        for m in self.modules():
            if isinstance(m, ATDGroup):
                nn.init.trunc_normal_(m.td, std=0.02, generator=generator)
            elif isinstance(m, ATDLayer):
                nn.init.zeros_(m.sigma)
                nn.init.zeros_(m.attn_atd.scale)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W) in [0, 1] -> (B, 3, H*scale, W*scale), fp32; in
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
        body = feat.permute(0, 2, 3, 1).contiguous()  # NHWC
        for group in self.layers:
            body = group(body)
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


def _atd_factory(**defaults):
    def factory(scale: int = 4, **kwargs):
        cfg = dict(defaults)
        # accepted-but-unused torch knobs, as the JAX factory drops them
        for k in ("img_size", "in_chans", "resi_connection"):
            kwargs.pop(k, None)
        cfg["compute_dtype"] = parse_dtype(kwargs)
        cfg.update(kwargs)
        cfg["depths"] = tuple(cfg["depths"])
        cfg["num_heads"] = tuple(cfg["num_heads"])
        cfg["mlp_ratio"] = float(cfg.get("mlp_ratio", 2))
        return ATD(upscale=scale, **cfg)

    return factory


atd = ARCH_REGISTRY.register(
    _atd_factory(embed_dim=210, depths=(6,) * 6, num_heads=(6,) * 6, window_size=16,
                 category_size=256, num_tokens=128, reducted_dim=20, convffn_kernel_size=5,
                 mlp_ratio=2),
    name="atd",
)
atd_light = ARCH_REGISTRY.register(
    _atd_factory(embed_dim=48, depths=(6,) * 4, num_heads=(6,) * 4, window_size=16,
                 category_size=128, num_tokens=64, reducted_dim=8, convffn_kernel_size=7,
                 mlp_ratio=1, upsampler="pixelshuffledirect"),
    name="atd_light",
)
