"""Fused post-norm SwinV2 block halves (Swin2SR): the CUDA kernels' wrappers
and their plain PyTorch versions.

Port of the JAX package's ops/pallas/fused_block_v2.py:

  fused_cos_attn_block : z   = x + s[b] * LN1(proj(cosMHSA(qkv(x))))
  fused_postnorm_mlp   : out = x + s[b] * LN2(fc2(gelu_erf(fc1(x))))

cosMHSA is SwinV2's cosine attention: q and k L2-normalised per row (the
norm clamped below at 1e-12), S = (q^ k^T) * scale[h] + bias[kind, h], a row
softmax, then P v. `scale` (nh,) arrives already exponentiated
(exp(min(logit_scale, log 100))) and `bias` (K, nh, n, n) is the kind table
(16 * sigmoid of the CPB MLP's table plus the shift masks): both are computed
outside the kernels, so autograd carries their gradients on to
`logit_scale` and the CPB MLP.

Both are torch.autograd.Functions. On a CUDA tensor the forward launches
TPU kernel #11's (#13's) port in `csrc/fused_block_v2.cu` and the backward
#12's (#14's), which recomputes the forward from x, as the JAX package
does; on a CPU tensor both directions run their plain versions
(`*_reference`, `*_bwd_reference`). Anything else raises. `s` is the
per-sample DropPath keep scale; it gets no gradient (as in JAX). Every
direction runs in stages through device memory: the per-token products on
the tensor-core engine (3xTF32), the window attention on mma.sync
(3xTF32), and, in the forwards, a row pass for the post-norm; the
wrappers allocate the stages' scratch.

Layout as in ops/fused_block.py: x is NHWC (B, H, W, C), H and W multiples
of the 8x8 window, weights (in, out), heads of at most 32 channels, fp32.
With shift > 0 the attention half takes the windows of x rolled by
(-shift, -shift) and returns z in x's frame, so the caller rolls nothing
(the JAX package rolls x and z around its kernel; the result is the same).
The MLP half is per token and takes no shift.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.ops.fused_block import (
    TC_ROWS,
    _check_aligned,
    _from_windows,
    _gelu_grad,
    _heads,
    _launch,
    _ln_backward,
    _ln_parts,
    _merge_heads,
    _roll,
    _row_scale,
    _sum_rows,
    _to_windows,
    _weight_grad,
    linear_smem_bytes,
    mlp_hidden_smem_bytes,
    residual_smem_bytes,
    rows_smem_bytes,
    tc_rows_fit,
)
from trainner_redux_tpu_torch.ops.window_attention import (
    HEAD_LD,
    SMEM_LIMIT,
    TILE,
    TILE_LD,
    _check_cuda,
    attn_fwd_tc_smem_bytes,
    heads_fit,
    window_kinds,
)

LIB = "fused_block_v2"
NORM_EPS = 1e-12  # the L2 norm's clamp (JAX _norm_rows, torch F.normalize)
PN_MAX_C = 768  # channels of a post-norm row pass's row (csrc/tc_rows.cuh kPnMaxC)


# ---------------------------------------------------------------------------
# shared-memory plans (csrc/fused_block_v2.cu) and the gate
# ---------------------------------------------------------------------------


def pn_mlp_fwd_smem_bytes(channels: int) -> int:
    """The largest shared memory of the MLP half's forward stages: hg on
    linear_kernel at a 128-column tile (any hidden width), m at the tile of
    a row of `channels`; the post-norm row pass takes none."""
    return max(linear_smem_bytes(), residual_smem_bytes(channels))


def cos_attn_fwd_smem_bytes(channels: int) -> int:
    """The largest shared memory of the attention half's forward stages (and
    of the backward's recompute): qkv and proj as the MLP half's products,
    the cosine window attention at 8x8 windows (k and v of the window, q
    and att of the 64 rows, the P tile, the exchanges, the token indices)."""
    return max(pn_mlp_fwd_smem_bytes(channels), attn_fwd_tc_smem_bytes(TILE))


def cos_attn_bwd_smem_bytes() -> int:
    """The attention half's backward, per-(window, head) stage on the tensor
    cores: q, k, v, datt (64, HEAD_LD) rows, the (64, 68) P / dS tile, three
    (2, 64) exchanges of the row halves' sums, the q and k rows' inverse
    norms, 8 warp sums, the 64 token indices."""
    return 4 * (4 * TILE * HEAD_LD + TILE * TILE_LD + 6 * TILE + 2 * TILE + 8 + TILE)


def pn_mlp_bwd_smem_bytes(channels: int, hidden: int) -> int:
    """The largest shared memory of the MLP half's backward kernels, all on
    the tensor-core engine: hg and m at 128-column tiles (linear_kernel),
    h and dh per 128 hidden units (mlp_hidden_kernel), dx over a row of
    `channels` (rows_kernel). None depends on `hidden`."""
    return max(linear_smem_bytes(), mlp_hidden_smem_bytes(), rows_smem_bytes(channels))


def cos_attn_fits(h, w, window_size, channels, num_heads, train=False) -> bool:
    """The attention half's forward (#11): 8x8 windows, window-aligned dims,
    heads of at most 32 channels, a post-norm row of at most PN_MAX_C
    channels; in training (#12) also rows the engine's backward kernels take
    (`tc_rows_fit`); each plan within one thread block's shared memory."""
    if h % window_size or w % window_size or channels > PN_MAX_C:
        return False
    if not heads_fit(window_size, channels, num_heads):
        return False
    plans = [cos_attn_fwd_smem_bytes(channels)]
    if train:
        if not tc_rows_fit(channels):  # the per-token stages run on the engine
            return False
        plans += [rows_smem_bytes(channels), cos_attn_bwd_smem_bytes()]
    return max(plans) <= SMEM_LIMIT


def pn_mlp_fits(h, window_size, channels, hidden, train=False) -> bool:
    """The MLP half's forward (#13): H a multiple of the caller's rows, a
    post-norm row of at most PN_MAX_C channels, any hidden width; in
    training (#14) also rows the engine's backward kernels take."""
    if h % window_size or channels > PN_MAX_C:
        return False
    plans = [pn_mlp_fwd_smem_bytes(channels)]
    if train:
        # the backward runs on the engine: rows of at most 256 channels,
        # rows of C and of hidden in 16-byte pieces
        if not tc_rows_fit(channels) or hidden % 4:
            return False
        plans.append(pn_mlp_bwd_smem_bytes(channels, hidden))
    return max(plans) <= SMEM_LIMIT


def fused_block_v2_supported(h: int, w: int, window_size: int, channels: int, num_heads: int,
                             hidden: int, train: bool = False) -> bool:
    """Gate for Swin2Block's kernel branch: 8x8 windows, window-aligned dims,
    heads of at most 32 channels, and the kernels' shared-memory plans (the
    backward's too when `train`) within one thread block's. TRAINNER_FUSED_BLOCK=0
    and TRAINNER_FUSED_ATTN=0 are the off switches. The device is not
    checked: on a CPU tensor the wrappers run their plain versions."""
    if os.environ.get("TRAINNER_FUSED_BLOCK", "1") == "0":
        return False
    if os.environ.get("TRAINNER_FUSED_ATTN", "1") == "0":
        return False
    return (cos_attn_fits(h, w, window_size, channels, num_heads, train)
            and pn_mlp_fits(h, window_size, channels, hidden, train))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _normalize(t):
    """(t / max(|t|, 1e-12), 1 / max(|t|, 1e-12)) over the last axis."""
    inv = 1.0 / torch.sqrt((t * t).sum(-1, keepdim=True)).clamp_min(NORM_EPS)
    return t * inv, inv


def _kind_table(bias, nwh, nww):
    kind = window_kinds(nwh, nww, bias.shape[0], device=bias.device)
    return bias.float()[kind].reshape(nwh, nww, *bias.shape[1:])


def fused_cos_attn_block_reference(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                                   window_size, eps=1e-5, shift=0):
    """The attention half's spec, in fp32 (differentiable)."""
    b, hh, ww, c = x.shape
    ws = window_size
    t = _roll(x.float(), -shift)
    qkv = _to_windows(t @ wq.float() + bq.float(), ws)
    q, k, v = (_heads(u, num_heads) for u in qkv.chunk(3, dim=-1))
    qn, kn = _normalize(q)[0], _normalize(k)[0]
    cos = qn @ kn.transpose(-1, -2)
    p = torch.softmax(cos * scale.float()[:, None, None] + _kind_table(bias, hh // ws, ww // ws),
                      dim=-1)
    att = _from_windows(_merge_heads(p @ v), ws)
    y = F.layer_norm(att @ wp.float() + bp.float(), (c,), g.float(), be.float(), eps)
    z = t + s.float()[:, None, None, None] * y
    return _roll(z, shift).to(x.dtype)


def fused_cos_attn_block_bwd_reference(x, wq, bq, scale, wp, bp, g, be, bias, s, dout,
                                       num_heads, head_dim, window_size, eps=1e-5, shift=0):
    """The attention half's backward, step by step as the JAX kernel takes
    it, in fp32: (dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias), the
    forward recomputed from x."""
    b, hh, ww, c = x.shape
    ws, nwh, nww, n = window_size, hh // window_size, ww // window_size, window_size**2
    kinds = bias.shape[0]

    def rows(u):
        return _roll(u.float(), -shift).reshape(b * hh * ww, -1)

    t, do = rows(x), rows(dout)
    wq, bq, wp, bp, g = wq.float(), bq.float(), wp.float(), bp.float(), g.float()
    sc = scale.float()[:, None, None]
    qkv = _to_windows((t @ wq + bq).reshape(b, hh, ww, 3 * c), ws)
    q, k, v = (_heads(u, num_heads) for u in qkv.chunk(3, dim=-1))
    qn, qinv = _normalize(q)
    kn, kinv = _normalize(k)
    cos = qn @ kn.transpose(-1, -2)
    p = torch.softmax(cos * sc + _kind_table(bias, nwh, nww), dim=-1)
    att = _from_windows(_merge_heads(p @ v), ws).reshape(-1, c)
    xn, inv = _ln_parts(att @ wp + bp, eps)
    dy = do * _row_scale(s, b, hh * ww)
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dproj = _ln_backward(dy, xn, inv, g)
    dwp, dbp = att.T @ dproj, dproj.sum(0)
    da = _heads(_to_windows((dproj @ wp.T).reshape(b, hh, ww, c), ws), num_heads)
    dv = p.transpose(-1, -2) @ da
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dscale = (ds * cos).sum(dim=(0, 1, 2, 4, 5))
    dcos = ds * sc
    dqn, dkn = dcos @ kn, dcos.transpose(-1, -2) @ qn
    dq = (dqn - qn * (qn * dqn).sum(-1, keepdim=True)) * qinv
    dk = (dkn - kn * (kn * dkn).sum(-1, keepdim=True)) * kinv
    dbias = torch.zeros(kinds, num_heads, n, n, dtype=torch.float32, device=x.device)
    dbias.index_add_(0, window_kinds(nwh, nww, kinds, device=x.device),
                     ds.sum(0).reshape(nwh * nww, num_heads, n, n))
    dqkv = torch.cat([_merge_heads(u) for u in (dq, dk, dv)], dim=-1)
    dqkv = _from_windows(dqkv, ws).reshape(-1, 3 * c)
    dwq, dbq = t.T @ dqkv, dqkv.sum(0)
    dx = _roll((do + dqkv @ wq.T).reshape(b, hh, ww, c), shift).to(x.dtype)
    return dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias


def fused_postnorm_mlp_reference(x, w1, b1, w2, b2, g, be, s, window_size, eps=1e-5):
    """The MLP half's spec, in fp32 (differentiable)."""
    b, hh, ww, c = x.shape
    t = x.reshape(-1, c).float()
    m = F.gelu(t @ w1.float() + b1.float(), approximate="none") @ w2.float() + b2.float()
    y = F.layer_norm(m, (c,), g.float(), be.float(), eps)
    return (t + _row_scale(s, b, hh * ww) * y).reshape(x.shape).to(x.dtype)


def fused_postnorm_mlp_bwd_reference(x, w1, b1, w2, b2, g, be, s, dout, window_size, eps=1e-5):
    """The MLP half's backward, step by step, in fp32: (dx, dw1, db1, dw2,
    db2, dg, dbe), fc1 and fc2 recomputed from x."""
    b, hh, ww, c = x.shape
    t, do = x.float().reshape(-1, c), dout.float().reshape(-1, c)
    w1, w2 = w1.float(), w2.float()
    h = t @ w1 + b1.float()
    hg = F.gelu(h, approximate="none")
    xn, inv = _ln_parts(hg @ w2 + b2.float(), eps)
    dy = do * _row_scale(s, b, hh * ww)
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dm = _ln_backward(dy, xn, inv, g.float())
    dw2, db2 = hg.T @ dm, dm.sum(0)
    dh = (dm @ w2.T) * _gelu_grad(h)
    dw1, db1 = t.T @ dh, dh.sum(0)
    dx = (do + dh @ w1.T).reshape(x.shape).to(x.dtype)
    return dx, dw1, db1, dw2, db2, dg, dbe


# ---------------------------------------------------------------------------
# the kernels' launches
# ---------------------------------------------------------------------------


def _attn_operands(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size,
                   shift, train, name):
    b, hh, ww, c = x.shape
    kinds, n = bias.shape[0], window_size**2
    if c != num_heads * head_dim or kinds not in (1, 4):
        raise ValueError(f"{name}: x {tuple(x.shape)}, {num_heads} heads of {head_dim}, "
                         f"bias {tuple(bias.shape)} do not match")
    if not 0 <= shift < min(hh, ww):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(hh, ww)})")
    if not cos_attn_fits(hh, ww, window_size, c, num_heads, train):
        raise ValueError(f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} "
                         "is outside the kernels' limits")
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    for k, t, shape in (
        ("x", x, (b, hh, ww, c)), ("wq", wq, (c, 3 * c)), ("bq", bq, (3 * c,)),
        ("scale", scale, (num_heads,)), ("wp", wp, (c, c)), ("bp", bp, (c,)), ("g", g, (c,)),
        ("be", be, (c,)), ("bias", bias, (kinds, num_heads, n, n)), ("s", s, (b,)),
    ):
        _check_cuda(k, t, shape, x.device)


def _cos_attn_forward(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                      window_size, eps, shift):
    name = "fused_cos_attn_block"
    _attn_operands(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size,
                   shift, False, name)
    _check_aligned(name, x=x, wq=wq, bq=bq, wp=wp, bp=bp, g=g, be=be, bias=bias)
    b, hh, ww, c = x.shape
    z = torch.empty_like(x)
    if z.numel() == 0:
        return z
    T = b * hh * ww  # the stages pass qkv, att and proj through (T, 3C), (T, C), (T, C)
    qkv, att, proj = (torch.empty((T, k), device=x.device, dtype=torch.float32)
                      for k in (3 * c, c, c))
    fused_cos_attn_block.launches += 1
    _launch(LIB, "trr_cos_attn_fwd", x.device,
            *(t.data_ptr() for t in (x, wq, bq, scale, wp, bp, g, be, bias, s, qkv, att, proj,
                                     z)),
            b, hh, ww, c, num_heads, bias.shape[0], shift, eps)
    return z


def fused_cos_attn_block_backward(x, wq, bq, scale, wp, bp, g, be, bias, s, dout, num_heads,
                                  head_dim, window_size, eps=1e-5, shift=0):
    """The attention half's backward (TPU kernel #12): (dx, dwq, dbq, dscale,
    dwp, dbp, dg, dbe, dbias), as `fused_cos_attn_block_bwd_reference`
    returns them. On a CUDA tensor it launches the backward's stages of
    `csrc/fused_block_v2.cu` (the per-token products on the tensor cores,
    from qkv = x wq + bq on), then the weight-gradient, row-sum and
    bias-kind kernels of `csrc/fused_block_train.cu` (one counted call); on
    a CPU tensor it runs the plain version."""
    args = (x, wq, bq, scale, wp, bp, g, be, bias, s)
    if x.device.type == "cpu":
        return fused_cos_attn_block_bwd_reference(*args, dout, num_heads, head_dim, window_size,
                                                  eps, shift)
    _attn_operands(*args, num_heads, head_dim, window_size, shift, True,
                   "fused_cos_attn_block_backward")
    _check_cuda("dout", dout, tuple(x.shape), x.device)
    name = "fused_cos_attn_block_backward"
    _check_aligned(name, x=x, dout=dout, wq=wq, bq=bq, wp=wp, bp=bp, g=g)
    b, hh, ww, c = x.shape
    T, dev, kinds = b * hh * ww, x.device, bias.shape[0]
    nwin = b * (hh // window_size) * (ww // window_size)

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    qkv, att, proj = new(T, 3 * c), new(T, c), new(T, c)
    dproj, datt, dqkv, dx = new(T, c), new(T, c), new(T, 3 * c), torch.empty_like(x)
    ln_part, dscale_part = new(math.ceil(T / TC_ROWS), 2 * c), new(nwin, num_heads)
    dS = new(nwin, num_heads, TILE, TILE)
    fused_cos_attn_block_backward.launches += 1
    _launch(LIB, "trr_cos_attn_bwd", dev,
            *(t.data_ptr() for t in (x, dout, wq, bq, scale, wp, bp, g, s, bias, qkv, att, proj,
                                     dproj, datt, ln_part, dqkv, dS, dscale_part, dx)),
            b, hh, ww, c, num_heads, kinds, shift, eps)
    dwq, dbq = _weight_grad(x.view(T, c), dqkv)
    dwp, dbp = _weight_grad(att, dproj)
    dg, dbe = _sum_rows(ln_part).split(c)
    dscale = _sum_rows(dscale_part)
    dbias = new(kinds, num_heads, TILE, TILE)
    _launch("fused_block_train", "trr_dbias", dev, dS.data_ptr(), b, hh // window_size,
            ww // window_size, num_heads, kinds, dbias.data_ptr())
    return dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias


fused_cos_attn_block_backward.launches = 0


def _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, train, name):
    b, hh, ww, c = x.shape
    hidden = w1.shape[-1]
    if not pn_mlp_fits(hh, window_size, c, hidden, train):
        raise ValueError(f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} is outside "
                         "the kernels' limits")
    if b * hh * ww * max(hidden, c) >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    for k, t, shape in (
        ("x", x, (b, hh, ww, c)), ("w1", w1, (c, hidden)), ("b1", b1, (hidden,)),
        ("w2", w2, (hidden, c)), ("b2", b2, (c,)), ("g", g, (c,)), ("be", be, (c,)),
        ("s", s, (b,)),
    ):
        _check_cuda(k, t, shape, x.device)


def _pn_mlp_forward(x, w1, b1, w2, b2, g, be, s, window_size, eps):
    name = "fused_postnorm_mlp"
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, False, name)
    _check_aligned(name, x=x, w1=w1, b1=b1, w2=w2, b2=b2, g=g, be=be)
    b, hh, ww, c = x.shape
    hidden, T = w1.shape[1], b * hh * ww
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # scratch: gelu(fc1 x), then fc2's rows
    hg, m = (torch.empty((T, k), device=x.device, dtype=torch.float32) for k in (hidden, c))
    fused_postnorm_mlp.launches += 1
    _launch(LIB, "trr_pn_mlp_fwd", x.device,
            *(t.data_ptr() for t in (x, w1, b1, w2, b2, g, be, s, hg, m, out)),
            b, hh, ww, c, hidden, eps)
    return out


def fused_postnorm_mlp_backward(x, w1, b1, w2, b2, g, be, s, dout, window_size, eps=1e-5):
    """The MLP half's backward (TPU kernel #14): (dx, dw1, db1, dw2, db2, dg,
    dbe), as `fused_postnorm_mlp_bwd_reference` returns them. On a CUDA
    tensor it launches the backward's stages of `csrc/fused_block_v2.cu`
    (every product on the tensor cores, fc1 and fc2 recomputed from x), then
    the weight-gradient and row-sum kernels of `csrc/fused_block_train.cu`
    (one counted call); on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return fused_postnorm_mlp_bwd_reference(x, w1, b1, w2, b2, g, be, s, dout, window_size,
                                                eps)
    name = "fused_postnorm_mlp_backward"
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, True, name)
    _check_cuda("dout", dout, tuple(x.shape), x.device)
    _check_aligned(name, x=x, dout=dout, w1=w1, b1=b1, w2=w2, b2=b2, g=g)
    b, hh, ww, c = x.shape
    hidden, dev, T = w1.shape[1], x.device, b * hh * ww

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    hg, dh, m, dm = new(T, hidden), new(T, hidden), new(T, c), new(T, c)
    dx, ln_part = torch.empty_like(x), new(math.ceil(T / TC_ROWS), 2 * c)
    fused_postnorm_mlp_backward.launches += 1
    _launch(LIB, "trr_pn_mlp_bwd", dev,
            *(t.data_ptr() for t in (x, dout, w1, b1, w2, b2, g, s, hg, m, dm, dh, dx, ln_part)),
            b, hh, ww, c, hidden, eps)
    dw2, db2 = _weight_grad(hg, dm)
    dw1, db1 = _weight_grad(x.view(T, c), dh)
    dg, dbe = _sum_rows(ln_part).split(c)
    return dx, dw1, db1, dw2, db2, dg, dbe


fused_postnorm_mlp_backward.launches = 0


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


class _CosAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                window_size, eps, shift):
        args = (x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size, eps,
                shift)
        if x.device.type == "cpu":
            z = fused_cos_attn_block_reference(*args)
        else:
            z = _cos_attn_forward(*args)
        ctx.save_for_backward(x, wq, bq, scale, wp, bp, g, be, bias, s)
        ctx.meta = (num_heads, head_dim, window_size, eps, shift)
        return z

    @staticmethod
    def backward(ctx, dz):
        grads = fused_cos_attn_block_backward(*ctx.saved_tensors, dz.contiguous(), *ctx.meta)
        return (*grads, None, None, None, None, None, None)


def fused_cos_attn_block(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                         window_size, eps=1e-5, shift=0):
    """z (B,H,W,C) = x + s[b] * LN(proj(cosMHSA(qkv(x), scale, bias))),
    differentiable in x, wq (C, 3C), bq (3C,), scale (nh,), wp (C, C), bp, g,
    be (C,) and bias (K, nh, n, n); not in s (B,). With shift > 0 the windows
    are those of x rolled by (-shift, -shift) and z comes back in x's frame.
    On a CUDA tensor the forward launches TPU kernel #11's port and the
    backward #12's (`fused_cos_attn_block_backward`); on a CPU tensor both
    run their plain versions."""
    return _CosAttn.apply(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                          window_size, eps, shift)


fused_cos_attn_block.launches = 0


class _PostnormMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, be, s, window_size, eps):
        args = (x, w1, b1, w2, b2, g, be, s, window_size, eps)
        if x.device.type == "cpu":
            out = fused_postnorm_mlp_reference(*args)
        else:
            out = _pn_mlp_forward(*args)
        ctx.save_for_backward(x, w1, b1, w2, b2, g, be, s)
        ctx.meta = (window_size, eps)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = fused_postnorm_mlp_backward(*ctx.saved_tensors, dout.contiguous(), *ctx.meta)
        return (*grads, None, None, None)


def fused_postnorm_mlp(x, w1, b1, w2, b2, g, be, s, window_size, eps=1e-5):
    """out (B,H,W,C) = x + s[b] * LN(fc2(gelu(fc1(x)))), differentiable in x,
    w1 (C, hidden), b1, w2 (hidden, C), b2, g and be; not in s (B,). On a
    CUDA tensor the forward launches TPU kernel #13's port and the backward
    #14's (`fused_postnorm_mlp_backward`); on a CPU tensor both run their
    plain versions."""
    return _PostnormMlp.apply(x, w1, b1, w2, b2, g, be, s, window_size, eps)


fused_postnorm_mlp.launches = 0
