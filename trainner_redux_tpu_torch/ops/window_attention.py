"""Shifted-window multi-head self-attention: the CUDA kernels' wrapper, their
plain PyTorch versions, and the bias-kind helpers.

Port of the JAX package's ops/pallas/window_attention.py. Layout contract
(the same):

  qkv  (B, H, W, 3C): one Dense over NHWC, channel groups [q | k | v], each
       C = num_heads * head_dim with heads contiguous.
  bias (K, nh, n, n) fp32, n = window_size**2: relative-position bias plus
       the cyclic-shift mask. K = 1 (unshifted: every window is kind 0) or 4
       (shifted: interior / right edge / bottom edge / corner); the kind of a
       window is 2 * is_bottom_row + is_rightmost_column.
  out  (B, H, W, C)

The kernels take 8x8 (n = 64, SwinIR) and 16x16 (n = 256, HAT) windows
and heads of at most 32 channels, in fp32. `fused_window_mhsa` is a
torch.autograd.Function: on a CUDA tensor its forward launches the forward
kernel of `csrc/window_attention.cu` (TPU kernel #3) and its backward the
backward kernel (#8), which recomputes the softmax from qkv and the bias and
returns dqkv and dbias; on a CPU tensor both directions run their plain
versions (`fused_window_mhsa_reference`, `fused_window_mhsa_bwd_reference`).
Any other device, or a tensor the kernels do not take, raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# shared memory one thread block may use on sm_90 (bytes)
SMEM_LIMIT = 232_448
# the kernels' tiles (csrc/common.cuh): 64 tokens (an 8x8 window, or 64
# query rows of a 16x16 one), transposed tiles of row stride 68, v rows of 32
# (so head_dim <= 32)
WINDOW = 8
WINDOWS = (8, 16)
TILE = 64
TILE_LD = 68
V_LD = 32


def window_mhsa_smem_bytes(channels: int, num_heads: int, window_size: int = WINDOW) -> int:
    """Shared memory of the forward kernel (csrc/window_attention.cu)."""
    hd, n = channels // num_heads, window_size**2
    if window_size == WINDOW:
        return 4 * (2 * hd * TILE_LD + TILE * V_LD + TILE * TILE_LD)
    return 4 * (hd * TILE_LD + hd * n + n * V_LD + TILE * (n + 4))


def window_mhsa_bwd_smem_bytes(channels: int, num_heads: int, window_size: int) -> int:
    """Shared memory of the backward kernel (csrc/window_attention.cu)."""
    hd, n = channels // num_heads, window_size**2
    return 4 * (2 * hd * n + n * V_LD + 2 * hd * TILE_LD + 2 * TILE * V_LD + TILE * (n + 4))


def heads_fit(window_size: int, channels: int, num_heads: int) -> bool:
    """8x8 windows and heads of at most 32 channels: the block kernels' tiles."""
    return (
        window_size == WINDOW
        and channels % num_heads == 0
        and channels // num_heads <= V_LD
    )


def window_mhsa_fits(h: int, w: int, window_size: int, channels: int, num_heads: int) -> bool:
    """The window kernels' limits: window-aligned spatial dims, 8x8 or 16x16
    windows, heads of at most 32 channels, and the forward's and backward's
    shared-memory plans within one thread block's."""
    if window_size not in WINDOWS or h % window_size or w % window_size:
        return False
    if channels % num_heads or channels // num_heads > V_LD:
        return False
    return max(window_mhsa_smem_bytes(channels, num_heads, window_size),
               window_mhsa_bwd_smem_bytes(channels, num_heads, window_size)) <= SMEM_LIMIT


def fused_window_mhsa_supported(
    h: int, w: int, window_size: int, channels: int, num_heads: int
) -> bool:
    """Whether a block's attention takes the kernels (SwinBlock's unfused
    branch, HAB): within their limits, unless TRAINNER_FUSED_ATTN=0 (the
    global off switch)."""
    if os.environ.get("TRAINNER_FUSED_ATTN", "1") == "0":
        return False
    return window_mhsa_fits(h, w, window_size, channels, num_heads)


def shift_mask_kinds(window_size: int, shift: int) -> np.ndarray:
    """The 4 distinct cyclic-shift attention masks (kind, n, n) fp32 for a
    shifted window layer: 0 interior, 1 right-edge column, 2 bottom-edge row,
    3 bottom-right corner. Equivalent to upstream SwinIR's calculate_mask
    evaluated per window position; windows not touching the wrapped edge see
    an all-zero mask. Masked pairs get -100 (not -inf), as upstream."""
    ws, s = window_size, shift
    n = ws * ws
    # segment id along one axis after cyclic shift by -s, for an edge window:
    # the last `s` positions wrapped around from the opposite image edge
    edge_seg = np.zeros((ws,), np.int32)
    edge_seg[ws - s :] = 1
    interior_seg = np.zeros((ws,), np.int32)

    masks = np.zeros((4, n, n), np.float32)
    for kind, (row_seg, col_seg) in enumerate(
        [
            (interior_seg, interior_seg),
            (interior_seg, edge_seg),
            (edge_seg, interior_seg),
            (edge_seg, edge_seg),
        ]
    ):
        seg = (row_seg[:, None] * 2 + col_seg[None, :]).reshape(-1)  # (n,)
        diff = seg[:, None] != seg[None, :]
        masks[kind] = np.where(diff, -100.0, 0.0)
    return masks


def window_kinds(nwh: int, nww: int, kinds: int, device=None) -> torch.Tensor:
    """(nwh * nww,) kind of each window, row-major over the window grid."""
    if kinds == 1:
        return torch.zeros(nwh * nww, dtype=torch.long, device=device)
    i = torch.arange(nwh, device=device)[:, None]
    j = torch.arange(nww, device=device)[None, :]
    return (2 * (i == nwh - 1) + (j == nww - 1)).reshape(-1).long()


def reference_window_mhsa(qkv, bias_full, num_heads, head_dim, window_size):
    """Plain PyTorch window MHSA with a per-window bias
    bias_full (nWh * nWw, nh, n, n), already including any shift mask."""
    b, hh, ww, _ = qkv.shape
    c = num_heads * head_dim
    ws = window_size
    n = ws * ws
    nwh, nww = hh // ws, ww // ws
    x = qkv.reshape(b, nwh, ws, nww, ws, 3 * c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, nwh * nww, n, 3, num_heads, head_dim)
    q, k, v = x.permute(3, 0, 1, 4, 2, 5).float()  # each (b, nw, nh, n, hd)
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k)
    s = s * (head_dim**-0.5) + bias_full[None].float()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhnm,bwhmd->bwhnd", p, v)
    o = o.permute(0, 1, 3, 2, 4).reshape(b, nwh, nww, ws, ws, c)
    return o.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c).to(qkv.dtype)


def fused_window_mhsa_reference(qkv, bias, num_heads, head_dim, window_size):
    """The kernel's spec: window MHSA with the (K, nh, n, n) kind table."""
    _, hh, ww, _ = qkv.shape
    ws = window_size
    idx = window_kinds(hh // ws, ww // ws, bias.shape[0], device=bias.device)
    return reference_window_mhsa(qkv, bias[idx], num_heads, head_dim, window_size)


def _check_cuda(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, the other operands on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def refuse_autograd(name: str, backward: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a call of a forward-only kernel: the
    kernel's output would carry no gradient back to its inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: its backward ({backward}) is not ported to CUDA, so this kernel "
            "would cut the gradient. Call it under torch.no_grad() or "
            "torch.inference_mode(); to train, use fused_swin_block_train or the plain "
            "branch (TRAINNER_FUSED_ATTN=0)."
        )


def fused_window_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, window_size):
    """The backward kernel's spec, step by step, in fp32: (dqkv (B,H,W,3C),
    dbias (K,nh,n,n)) of `fused_window_mhsa_reference` for the output
    gradient dout (B,H,W,C), the softmax recomputed from qkv and the bias."""
    b, hh, ww, _ = qkv.shape
    ws, n, kinds = window_size, window_size**2, bias.shape[0]
    nwh, nww = hh // ws, ww // ws

    def windows(t):  # (B, H, W, X) -> (B, nW, n, X)
        t = t.float().reshape(b, nwh, ws, nww, ws, -1).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(b, nwh * nww, n, -1)

    def heads(t):  # (B, nW, n, nh*hd) -> (B, nW, nh, n, hd)
        return t.unflatten(-1, (num_heads, head_dim)).transpose(2, 3)

    q, k, v = (heads(t) for t in windows(qkv).chunk(3, dim=-1))
    do = heads(windows(dout))
    kind = window_kinds(nwh, nww, kinds, device=bias.device)
    scale = head_dim**-0.5
    p = torch.softmax(q @ k.transpose(-1, -2) * scale + bias.float()[kind], dim=-1)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq, dk = ds @ k * scale, ds.transpose(-1, -2) @ q * scale
    dbias = torch.zeros(kinds, num_heads, n, n, dtype=torch.float32, device=qkv.device)
    dbias.index_add_(0, kind, ds.sum(0))
    dqkv = torch.cat([t.transpose(2, 3).flatten(-2) for t in (dq, dk, dv)], dim=-1)
    dqkv = dqkv.reshape(b, nwh, nww, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return dqkv.reshape(b, hh, ww, -1).to(qkv.dtype), dbias.to(bias.dtype)


def _check_window_shapes(name, qkv, bias, num_heads, head_dim, window_size):
    b, hh, ww, c3 = qkv.shape
    c, n, kinds = num_heads * head_dim, window_size**2, bias.shape[0]
    if c3 != 3 * c or kinds not in (1, 4):
        raise ValueError(f"qkv {tuple(qkv.shape)} / bias {tuple(bias.shape)} do not match")
    _check_cuda("qkv", qkv, (b, hh, ww, 3 * c), qkv.device)
    _check_cuda("bias", bias, (kinds, num_heads, n, n), qkv.device)
    if not window_mhsa_fits(hh, ww, window_size, c, num_heads):
        raise ValueError(
            f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} "
            "is outside the kernels' limits"
        )
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")


def _window_mhsa_fwd_cuda(qkv, bias, num_heads, head_dim, window_size):
    _check_window_shapes("fused_window_mhsa", qkv, bias, num_heads, head_dim, window_size)
    b, hh, ww, _ = qkv.shape
    c = num_heads * head_dim
    out = torch.empty((b, hh, ww, c), device=qkv.device, dtype=qkv.dtype)
    if out.numel() == 0:
        return out
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("window_attention")
    with torch.cuda.device(qkv.device):
        fused_window_mhsa.launches += 1
        status = lib.trr_window_mhsa_fwd(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, hh, ww, c, num_heads, bias.shape[0], window_size, head_dim**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "fused_window_mhsa")
    return out


def fused_window_mhsa_backward(qkv, bias, dout, num_heads, head_dim, window_size):
    """(dqkv, dbias) of `fused_window_mhsa` for the output gradient dout
    (TPU kernel #8). On a CUDA tensor it launches the backward kernel and the
    bias-kind reduction of `csrc/window_attention.cu` (one counted call); on
    a CPU tensor it runs the plain version."""
    if qkv.device.type == "cpu":
        return fused_window_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, window_size)
    name = "fused_window_mhsa_backward"
    _check_window_shapes(name, qkv, bias, num_heads, head_dim, window_size)
    b, hh, ww, _ = qkv.shape
    c, ws, n, kinds = num_heads * head_dim, window_size, window_size**2, bias.shape[0]
    _check_cuda("dout", dout, (b, hh, ww, c), qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    # dS of every window and head, which the bias-kind reduction sums
    ds = torch.empty((b, hh // ws, ww // ws, num_heads, n, n), device=qkv.device,
                     dtype=torch.float32)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("window_attention")
    with torch.cuda.device(qkv.device):
        fused_window_mhsa_backward.launches += 1
        status = lib.trr_window_mhsa_bwd(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), ds.data_ptr(),
            dbias.data_ptr(), b, hh, ww, c, num_heads, kinds, ws, head_dim**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, name)
    return dqkv, dbias


fused_window_mhsa_backward.launches = 0


class _WindowMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, head_dim, window_size):
        if qkv.device.type == "cpu":
            out = fused_window_mhsa_reference(qkv, bias, num_heads, head_dim, window_size)
        else:
            out = _window_mhsa_fwd_cuda(qkv, bias, num_heads, head_dim, window_size)
        ctx.save_for_backward(qkv, bias)
        ctx.meta = (num_heads, head_dim, window_size)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = fused_window_mhsa_backward(qkv, bias, dout.contiguous(), *ctx.meta)
        return dqkv, dbias, None, None, None


def fused_window_mhsa(qkv, bias, num_heads, head_dim, window_size):
    """out (B,H,W,C) = window-MHSA(qkv (B,H,W,3C), bias (K,nh,n,n)),
    differentiable in qkv and bias.

    On a CUDA tensor the forward launches TPU kernel #3's port (ws 8 or 16)
    and the backward #8's (`fused_window_mhsa_backward`); on a CPU tensor
    both run their plain versions."""
    return _WindowMhsa.apply(qkv, bias, num_heads, head_dim, window_size)


fused_window_mhsa.launches = 0
