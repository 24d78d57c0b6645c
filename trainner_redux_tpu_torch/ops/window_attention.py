"""Shifted-window multi-head self-attention: the CUDA kernel's wrapper, its
plain PyTorch version, and the bias-kind helpers.

Port of the JAX package's ops/pallas/window_attention.py. Layout contract
(the same):

  qkv  (B, H, W, 3C): one Dense over NHWC, channel groups [q | k | v], each
       C = num_heads * head_dim with heads contiguous.
  bias (K, nh, n, n) fp32, n = window_size**2: relative-position bias plus
       the cyclic-shift mask. K = 1 (unshifted: every window is kind 0) or 4
       (shifted: interior / right edge / bottom edge / corner); the kind of a
       window is 2 * is_bottom_row + is_rightmost_column.
  out  (B, H, W, C)

The kernel takes 8x8 windows (n = 64) and heads of at most 32 channels,
in fp32. `fused_window_mhsa` launches `csrc/window_attention.cu` for a CUDA tensor
and runs `fused_window_mhsa_reference` for a CPU tensor; any other device,
or a tensor the kernel does not take, raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# shared memory one thread block may use on sm_90 (bytes)
SMEM_LIMIT = 232_448
# the kernels' tiles (csrc/common.cuh): 8x8 windows of 64 tokens, transposed
# tiles of row stride 68, v rows of 32 (so head_dim <= 32)
WINDOW = 8
TILE_LD = 68
V_LD = 32


def window_mhsa_smem_bytes(channels: int, num_heads: int) -> int:
    """Shared memory of the kernel (csrc/window_attention.cu)."""
    hd = channels // num_heads
    return 4 * (2 * hd * TILE_LD + 64 * V_LD + 64 * TILE_LD)


def heads_fit(window_size: int, channels: int, num_heads: int) -> bool:
    """8x8 windows and heads of at most 32 channels: the kernels' tiles."""
    return (
        window_size == WINDOW
        and channels % num_heads == 0
        and channels // num_heads <= V_LD
    )


def window_mhsa_fits(h: int, w: int, window_size: int, channels: int, num_heads: int) -> bool:
    """The kernel's limits: window-aligned spatial dims, its tiles, and its
    shared-memory plan within one thread block's."""
    if h % window_size or w % window_size or not heads_fit(window_size, channels, num_heads):
        return False
    return window_mhsa_smem_bytes(channels, num_heads) <= SMEM_LIMIT


def fused_window_mhsa_supported(
    h: int, w: int, window_size: int, channels: int, num_heads: int
) -> bool:
    """Whether SwinBlock's unfused branch takes the kernel: within its
    limits, unless TRAINNER_FUSED_ATTN=0 (the global off switch)."""
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


def fused_window_mhsa(qkv, bias, num_heads, head_dim, window_size):
    """out (B,H,W,C) = window-MHSA(qkv (B,H,W,3C), bias (K,nh,n,n)).

    Forward only: on a CUDA tensor that autograd would record, it raises."""
    if qkv.device.type == "cpu":
        return fused_window_mhsa_reference(qkv, bias, num_heads, head_dim, window_size)
    refuse_autograd("fused_window_mhsa", "TPU kernel #8, window_attention.py:371", qkv, bias)
    b, hh, ww, c3 = qkv.shape
    c, ws, n = num_heads * head_dim, window_size, window_size * window_size
    kinds = bias.shape[0]
    if c3 != 3 * c or kinds not in (1, 4):
        raise ValueError(f"qkv {tuple(qkv.shape)} / bias {tuple(bias.shape)} do not match")
    if not window_mhsa_fits(hh, ww, ws, c, num_heads):
        raise ValueError(
            f"fused_window_mhsa: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={ws} "
            "is outside the kernel's limits"
        )
    _check_cuda("qkv", qkv, (b, hh, ww, 3 * c), qkv.device)
    _check_cuda("bias", bias, (kinds, num_heads, n, n), qkv.device)
    out = torch.empty((b, hh, ww, c), device=qkv.device, dtype=qkv.dtype)
    if out.numel() == 0:
        return out
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("window_attention")
    with torch.cuda.device(qkv.device):
        fused_window_mhsa.launches += 1
        status = lib.trr_window_mhsa_fwd(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, hh, ww, c, num_heads, kinds, head_dim**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "fused_window_mhsa")
    return out


fused_window_mhsa.launches = 0
