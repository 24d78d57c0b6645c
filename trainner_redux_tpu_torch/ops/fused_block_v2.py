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
per-sample DropPath keep scale; it gets no gradient (as in JAX).

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
    STAGE_FLOATS,
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
)
from trainner_redux_tpu_torch.ops.window_attention import (
    SMEM_LIMIT,
    TILE,
    TILE_LD,
    V_LD,
    _check_cuda,
    heads_fit,
    window_kinds,
)

LIB = "fused_block_v2"
NORM_EPS = 1e-12  # the L2 norm's clamp (JAX _norm_rows, torch F.normalize)


# ---------------------------------------------------------------------------
# shared-memory plans (csrc/fused_block_v2.cu) and the gate
# ---------------------------------------------------------------------------


def cos_attn_fwd_smem_bytes(channels: int, num_heads: int) -> int:
    """The attention half's forward (and its recompute)."""
    hd = channels // num_heads
    return 4 * (2 * channels * TILE_LD + 2 * hd * TILE_LD + TILE * V_LD + TILE * TILE_LD
                + STAGE_FLOATS + 2 * TILE)


def pn_mlp_fwd_smem_bytes(channels: int, hidden: int) -> int:
    """The MLP half's forward."""
    return 4 * (channels * TILE_LD + hidden * TILE_LD + STAGE_FLOATS)


def postnorm_ln_bwd_smem_bytes(channels: int) -> int:
    """The attention half's backward, LN1 stage."""
    return 4 * (TILE * (channels + 1) + channels * TILE_LD + STAGE_FLOATS + 3 * TILE)


def cos_attn_bwd_smem_bytes(head_dim: int) -> int:
    """The attention half's backward, per-window stage."""
    return 4 * (4 * TILE * V_LD + 4 * head_dim * TILE_LD + 3 * TILE * TILE_LD + 2 * TILE + 8)


def qkv_dx_smem_bytes(channels: int) -> int:
    """The attention half's backward, dx stage."""
    return 4 * (3 * channels * TILE_LD + STAGE_FLOATS)


def pn_mlp_bwd_smem_bytes(channels: int, hidden: int) -> int:
    """The MLP half's backward."""
    return 4 * (2 * channels * TILE_LD + hidden * TILE_LD + STAGE_FLOATS + 3 * TILE)


def cos_attn_fits(h, w, window_size, channels, num_heads, train=False) -> bool:
    # the proj rows, (64, C + 1), live in the (C, 68) x tile: C >= 16
    if h % window_size or w % window_size or channels < 16:
        return False
    if not heads_fit(window_size, channels, num_heads):
        return False
    plans = [cos_attn_fwd_smem_bytes(channels, num_heads)]
    if train:
        plans += [postnorm_ln_bwd_smem_bytes(channels),
                  cos_attn_bwd_smem_bytes(channels // num_heads), qkv_dx_smem_bytes(channels)]
    return max(plans) <= SMEM_LIMIT


def pn_mlp_fits(h, window_size, channels, hidden, train=False) -> bool:
    if h % window_size or channels < 16:
        return False
    plans = [pn_mlp_fwd_smem_bytes(channels, hidden)]
    if train:
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


def _cos_attn_fwd_cuda(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                       window_size, eps, shift, saves=None):
    """Launch the forward kernel: z, or with `saves` = (qkv, att, proj)
    buffers the backward's recompute (no z)."""
    b, hh, ww, c = x.shape
    z = torch.empty_like(x) if saves is None else None
    outs = (z, *(saves or (None, None, None)))
    if x.numel():
        _launch(LIB, "trr_cos_attn_fwd", x.device,
                *(t.data_ptr() for t in (x, wq, bq, scale, wp, bp, g, be, bias, s)),
                *(None if t is None else t.data_ptr() for t in outs),
                b, hh, ww, c, num_heads, bias.shape[0], shift, eps)
    return z


def _cos_attn_forward(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                      window_size, eps, shift):
    _attn_operands(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size,
                   shift, False, "fused_cos_attn_block")
    if x.numel():
        fused_cos_attn_block.launches += 1
    return _cos_attn_fwd_cuda(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                              window_size, eps, shift)


def fused_cos_attn_block_backward(x, wq, bq, scale, wp, bp, g, be, bias, s, dout, num_heads,
                                  head_dim, window_size, eps=1e-5, shift=0):
    """The attention half's backward (TPU kernel #12): (dx, dwq, dbq, dscale,
    dwp, dbp, dg, dbe, dbias), as `fused_cos_attn_block_bwd_reference`
    returns them. On a CUDA tensor it launches the recompute and the
    backward stages of `csrc/fused_block_v2.cu`, then the weight-gradient,
    row-sum and bias-kind kernels of `csrc/fused_block_train.cu` (one
    counted call); on a CPU tensor it runs the plain version."""
    args = (x, wq, bq, scale, wp, bp, g, be, bias, s)
    if x.device.type == "cpu":
        return fused_cos_attn_block_bwd_reference(*args, dout, num_heads, head_dim, window_size,
                                                  eps, shift)
    _attn_operands(*args, num_heads, head_dim, window_size, shift, True,
                   "fused_cos_attn_block_backward")
    _check_cuda("dout", dout, tuple(x.shape), x.device)
    b, hh, ww, c = x.shape
    T, dev, kinds = b * hh * ww, x.device, bias.shape[0]
    nwin = b * (hh // window_size) * (ww // window_size)

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    qkv, att, proj = new(T, 3 * c), new(T, c), new(T, c)
    dproj, datt, dqkv, dx = new(T, c), new(T, c), new(T, 3 * c), torch.empty_like(x)
    ln_part, dscale_part = new(math.ceil(T / TILE), 2 * c), new(nwin, num_heads)
    dS = new(nwin, num_heads, TILE, TILE)
    fused_cos_attn_block_backward.launches += 1
    _cos_attn_fwd_cuda(*args, num_heads, head_dim, window_size, eps, shift, (qkv, att, proj))
    wpt, wqt = wp.t().contiguous(), wq.t().contiguous()
    _launch(LIB, "trr_cos_attn_bwd", dev,
            *(t.data_ptr() for t in (proj, dout, g, s, wpt, qkv, scale, bias, wqt, dproj, datt,
                                     ln_part, dqkv, dS, dscale_part, dx)),
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
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, False, "fused_postnorm_mlp")
    b, hh, ww, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fused_postnorm_mlp.launches += 1
    _launch(LIB, "trr_pn_mlp_fwd", x.device,
            *(t.data_ptr() for t in (x, w1, b1, w2, b2, g, be, s, out)),
            b, hh, ww, c, w1.shape[1], eps)
    return out


def fused_postnorm_mlp_backward(x, w1, b1, w2, b2, g, be, s, dout, window_size, eps=1e-5):
    """The MLP half's backward (TPU kernel #14): (dx, dw1, db1, dw2, db2, dg,
    dbe), as `fused_postnorm_mlp_bwd_reference` returns them. On a CUDA
    tensor it launches the per-token kernel of `csrc/fused_block_v2.cu` and
    the weight-gradient kernels of `csrc/fused_block_train.cu` (one counted
    call); on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return fused_postnorm_mlp_bwd_reference(x, w1, b1, w2, b2, g, be, s, dout, window_size,
                                                eps)
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, True, "fused_postnorm_mlp_backward")
    _check_cuda("dout", dout, tuple(x.shape), x.device)
    b, hh, ww, c = x.shape
    hidden, dev, T = w1.shape[1], x.device, b * hh * ww

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    hg, dh, dm = new(T, hidden), new(T, hidden), new(T, c)
    dx, ln_part = torch.empty_like(x), new(math.ceil(T / TILE), 2 * c)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    fused_postnorm_mlp_backward.launches += 1
    _launch(LIB, "trr_pn_mlp_bwd", dev,
            *(t.data_ptr() for t in (x, dout, w1, b1, w2, b2, w1t, w2t, g, s, hg, dm, dh, dx,
                                     ln_part)),
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
