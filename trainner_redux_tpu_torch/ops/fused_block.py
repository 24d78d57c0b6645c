"""Fused pre-LN transformer block halves: the CUDA kernels' wrappers and
their plain PyTorch versions.

Port of the forward of the JAX package's ops/pallas/fused_block.py:

  fused_attn_block : z   = x + s[b] * proj(window-MHSA(qkv(LN1(x))))
  fused_ln_mlp     : out = x + s[b] * fc2(gelu_erf(fc1(LN2(x))))

`s` is the per-sample DropPath keep scale (ones at eval). Layout contract
as in ops/window_attention.py: x is NHWC (B, H, W, C) with H and W
multiples of window_size, weights are (in, out), the bias table is
(K, nh, n, n). The kernels take 8x8 windows (n = 64) and heads of at most
32 channels, in fp32. The cyclic shift of a shifted block is either done by
the caller (roll x, unroll z; the JAX package's contract) or, with
`fused_attn_block(..., shift=s)`, by the kernel's indexing. The MLP half is
per-token and needs no roll.

For a CUDA tensor each wrapper launches its kernel in
`csrc/fused_block.cu`; for a CPU tensor it runs its plain version
(`*_reference`); anything else raises.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.ops.window_attention import (
    SMEM_LIMIT,
    TILE_LD,
    V_LD,
    _check_cuda,
    fused_window_mhsa_reference,
    heads_fit,
)

STAGE_FLOATS = 2 * 32 * 96  # double-buffered weight stage (kStageFloats)


def attn_block_smem_bytes(channels: int, num_heads: int) -> int:
    """Shared memory of the attention-half kernel (csrc/fused_block.cu)."""
    hd = channels // num_heads
    return 4 * (2 * channels * TILE_LD + 2 * hd * TILE_LD + 64 * V_LD + 64 * TILE_LD
                + STAGE_FLOATS + 128)


def ln_mlp_smem_bytes(channels: int, hidden: int) -> int:
    """Shared memory of the MLP-half kernel (csrc/fused_block.cu)."""
    return 4 * (channels * TILE_LD + hidden * TILE_LD + STAGE_FLOATS + 128)


def attn_block_fits(h, w, window_size, channels, num_heads) -> bool:
    # the LayerNorm's (64, C + 1) scratch lives in the (C, 68) attention tile
    if h % window_size or w % window_size or channels < 16:
        return False
    if not heads_fit(window_size, channels, num_heads):
        return False
    return attn_block_smem_bytes(channels, num_heads) <= SMEM_LIMIT


def ln_mlp_fits(h, window_size, channels, hidden) -> bool:
    # the LayerNorm's (64, C + 1) scratch lives in the (hidden, 68) tile
    if h % window_size or 64 * (channels + 1) > hidden * TILE_LD:
        return False
    return ln_mlp_smem_bytes(channels, hidden) <= SMEM_LIMIT


def fused_block_supported(
    h: int, w: int, window_size: int, channels: int, num_heads: int, hidden: int
) -> bool:
    """Gate for SwinBlock's fused branch: window-aligned dims, 8x8 windows,
    heads of at most 32 channels, and both kernels' shared-memory plans
    within one thread block's limit.
    TRAINNER_FUSED_BLOCK=0 and TRAINNER_FUSED_ATTN=0 are the off switches."""
    if os.environ.get("TRAINNER_FUSED_BLOCK", "1") == "0":
        return False
    if os.environ.get("TRAINNER_FUSED_ATTN", "1") == "0":
        return False
    return attn_block_fits(h, w, window_size, channels, num_heads) and ln_mlp_fits(
        h, window_size, channels, hidden
    )


def _row_scale(s, b, tokens_per_sample):
    return s.float().repeat_interleave(tokens_per_sample)[:, None]


def fused_ln_mlp_reference(x, g, be, w1, b1, w2, b2, s, window_size, eps=1e-5):
    """The MLP kernel's spec, in fp32."""
    b, hh, ww, c = x.shape
    t = x.reshape(-1, c).float()
    y = F.layer_norm(t, (c,), g.float(), be.float(), eps)
    hid = F.gelu(y @ w1.float() + b1.float(), approximate="none")
    m = hid @ w2.float() + b2.float()
    out = t + _row_scale(s, b, hh * ww) * m
    return out.reshape(x.shape).to(x.dtype)


def fused_attn_block_reference(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                               window_size, eps=1e-5, shift=0):
    """The attention-half kernel's spec, in fp32 (row softmax)."""
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        z = fused_attn_block_reference(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                                       window_size, eps)
        return torch.roll(z, (shift, shift), dims=(1, 2))
    b, hh, ww, c = x.shape
    t = x.reshape(-1, c).float()
    y = F.layer_norm(t, (c,), g.float(), be.float(), eps)
    qkv = (y @ wq.float() + bq.float()).reshape(b, hh, ww, 3 * c)
    att = fused_window_mhsa_reference(qkv, bias.float(), num_heads, head_dim, window_size)
    proj = att.reshape(-1, c) @ wp.float() + bp.float()
    out = t + _row_scale(s, b, hh * ww) * proj
    return out.reshape(x.shape).to(x.dtype)


def _launch(fn_name: str, device, *args) -> None:
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("fused_block")
    with torch.cuda.device(device):
        status = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(status, fn_name)


def fused_ln_mlp(x, g, be, w1, b1, w2, b2, s, window_size, eps=1e-5):
    """out (B,H,W,C) = x + s[b] * fc2(gelu(fc1(LN(x)))).

    g/be (C,) LayerNorm affine, w1 (C, hidden), b1 (hidden,), w2 (hidden, C),
    b2 (C,), s (B,) per-sample DropPath keep scale (ones at eval)."""
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, g, be, w1, b1, w2, b2, s, window_size, eps)
    b, hh, ww, c = x.shape
    hidden = w1.shape[1]
    if not ln_mlp_fits(hh, window_size, c, hidden):
        raise ValueError(
            f"fused_ln_mlp: H={hh}, C={c}, hidden={hidden}, ws={window_size} "
            "is outside the kernel's limits"
        )
    for name, t, shape in (
        ("x", x, (b, hh, ww, c)), ("g", g, (c,)), ("be", be, (c,)),
        ("w1", w1, (c, hidden)), ("b1", b1, (hidden,)), ("w2", w2, (hidden, c)),
        ("b2", b2, (c,)), ("s", s, (b,)),
    ):
        _check_cuda(name, t, shape, x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fused_ln_mlp.launches += 1
    _launch(
        "trr_ln_mlp_fwd", x.device,
        x.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), s.data_ptr(), out.data_ptr(),
        b, hh, ww, c, hidden, eps,
    )
    return out


fused_ln_mlp.launches = 0


def fused_attn_block(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                     eps=1e-5, shift=0):
    """z (B,H,W,C) = x + s[b] * proj(window-MHSA(qkv(LN(x)), bias)).

    wq (C, 3C), bq (3C,), wp (C, C), bp (C,), bias (K, nh, n, n) fp32 kind
    table (relative-position bias + shift mask, see
    window_attention.shift_mask_kinds), s (B,) DropPath keep scale. With
    shift=0, as in the JAX package, the caller passes x already rolled and
    unrolls z; with shift > 0 the kernel takes the windows of x rolled by
    (-shift, -shift) and returns z unrolled, in x's frame."""
    if x.device.type == "cpu":
        return fused_attn_block_reference(
            x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size, eps, shift
        )
    b, hh, ww, c = x.shape
    ws, n, kinds = window_size, window_size * window_size, bias.shape[0]
    if c != num_heads * head_dim or kinds not in (1, 4):
        raise ValueError(f"x {tuple(x.shape)} / bias {tuple(bias.shape)} do not match")
    if not 0 <= shift < min(hh, ww):
        raise ValueError(f"fused_attn_block: shift {shift} outside [0, {min(hh, ww)})")
    if not attn_block_fits(hh, ww, ws, c, num_heads):
        raise ValueError(
            f"fused_attn_block: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={ws} "
            "is outside the kernel's limits"
        )
    for name, t, shape in (
        ("x", x, (b, hh, ww, c)), ("g", g, (c,)), ("be", be, (c,)),
        ("wq", wq, (c, 3 * c)), ("bq", bq, (3 * c,)), ("wp", wp, (c, c)),
        ("bp", bp, (c,)), ("bias", bias, (kinds, num_heads, n, n)), ("s", s, (b,)),
    ):
        _check_cuda(name, t, shape, x.device)
    z = torch.empty_like(x)
    if z.numel() == 0:
        return z
    fused_attn_block.launches += 1
    _launch(
        "trr_attn_block_fwd", x.device,
        x.data_ptr(), g.data_ptr(), be.data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), bias.data_ptr(), s.data_ptr(), z.data_ptr(),
        b, hh, ww, c, num_heads, kinds, shift, eps, head_dim**-0.5,
    )
    return z


fused_attn_block.launches = 0
