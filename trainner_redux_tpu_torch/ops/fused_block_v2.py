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

A bf16 x (a bf16 training step) runs the bf16 forms, `*_bf16` and
`*_backward_bf16`: the same stages on bf16 activations with bf16 products
(fp32 sums) on the bf16 engine and mma.sync m16n8k16, rounding where the JAX
kernel rounds in bf16, the parameter gradients fp32. Their gates
(`cos_attn_bf16_fits`, `pn_mlp_bf16_fits`) are the bf16 plans'; a bf16 x on
the card outside them raises.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.ops.fused_block import (
    ROWS_MAX_C,
    TC_ROWS,
    _check_aligned,
    _from_windows,
    _gelu_grad,
    _heads,
    _launch,
    _ln_backward,
    _ln_parts,
    _merge_heads,
    _part_floats,
    _part_floats_bf16,
    _roll,
    _row_scale,
    _split_grad,
    _sum_rows,
    _to_windows,
    _weight_grad,
    linear_smem_bytes,
    mlp_hidden_smem_bytes,
    residual_smem_bytes,
    residual_tile_cols,
    rows_bf16_smem_bytes,
    rows_smem_bytes,
    tc_rows_fit,
    weight_grad_bf16_smem_bytes,
    wg_bf16_bytes,
)
from trainner_redux_tpu_torch.ops.window_attention import (
    HEAD_LD,
    SMEM_LIMIT,
    TILE,
    TILE_LD,
    V_LD,
    WINDOW,
    _bf,
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


def cos_attn_bf16_smem_bytes(channels: int) -> int:
    """The largest shared memory of the bf16 attention half's kernels (#11
    and #12's bf16 forms): qkv and proj on linear_bf16_kernel, datt and dx on
    rows_bf16_kernel, the weight gradients (dwq over 3C columns, dwp over C:
    csrc/wgrad_bf16.cuh), the cosine window attention's forward and its
    backward stage (the fp32 plans: their tiles are fp32 in either form)."""
    return max(wg_bf16_bytes(residual_tile_cols(3 * channels)),
               wg_bf16_bytes(residual_tile_cols(channels)), rows_bf16_smem_bytes(channels),
               weight_grad_bf16_smem_bytes(3 * channels), weight_grad_bf16_smem_bytes(channels),
               attn_fwd_tc_smem_bytes(TILE),
               cos_attn_bwd_smem_bytes())


def pn_mlp_bf16_smem_bytes(channels: int, hidden: int) -> int:
    """The largest shared memory of the bf16 MLP half's kernels (#13 and
    #14's bf16 forms): fc1 and fc2 on linear_bf16_kernel, h and dh on
    mlp_hidden_bf16_kernel (gelu'(h) of its (128, 128) tile beside its
    buffers), dx on rows_bf16_kernel, the weight gradients."""
    return max(wg_bf16_bytes(residual_tile_cols(hidden)),
               wg_bf16_bytes(residual_tile_cols(channels)), 4 * TC_ROWS * 128 + wg_bf16_bytes(128),
               rows_bf16_smem_bytes(channels), weight_grad_bf16_smem_bytes(channels),
               weight_grad_bf16_smem_bytes(hidden))


def cos_attn_bf16_fits(h, w, window_size, channels, num_heads) -> bool:
    """#11 and #12's bf16 forms: 8x8 windows, window-aligned dims, heads of
    at most 32 channels, rows the bf16 engine takes (C <= ROWS_MAX_C, a
    multiple of 4) and each plan within one thread block's shared memory."""
    if window_size != WINDOW or h % window_size or w % window_size:
        return False
    if not heads_fit(window_size, channels, num_heads) or not tc_rows_fit(channels):
        return False
    return cos_attn_bf16_smem_bytes(channels) <= SMEM_LIMIT


def pn_mlp_bf16_fits(h, window_size, channels, hidden) -> bool:
    """#13 and #14's bf16 forms: H a multiple of the caller's rows, rows the
    bf16 engine takes, hidden a multiple of 4, each plan within one thread
    block's shared memory."""
    if h % window_size or not tc_rows_fit(channels) or hidden % 4:
        return False
    return pn_mlp_bf16_smem_bytes(channels, hidden) <= SMEM_LIMIT


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


# the bf16 forms' limits, as their refusals name them
BF16_LIMITS = f"C <= {ROWS_MAX_C} and a multiple of 4"


def _attn_operands(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size,
                   shift, train, name, dout=None, bf16=False):
    """Shapes, limits, types and placement of the attention half's operands:
    x (and dout) fp32, or bf16 for the bf16 forms (`bf16`: their gate
    `cos_attn_bf16_fits`), everything else fp32."""
    b, hh, ww, c = x.shape
    kinds, n = bias.shape[0], window_size**2
    if c != num_heads * head_dim or kinds not in (1, 4):
        raise ValueError(f"{name}: x {tuple(x.shape)}, {num_heads} heads of {head_dim}, "
                         f"bias {tuple(bias.shape)} do not match")
    if not 0 <= shift < min(hh, ww):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(hh, ww)})")
    if bf16 and not cos_attn_bf16_fits(hh, ww, window_size, c, num_heads):
        raise ValueError(f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} "
                         f"is outside the bf16 form's limits (8x8 windows, heads of at most "
                         f"{V_LD} channels, {BF16_LIMITS})")
    if not bf16 and not cos_attn_fits(hh, ww, window_size, c, num_heads, train):
        raise ValueError(f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} "
                         "is outside the kernels' limits")
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    xdtype = torch.bfloat16 if bf16 else torch.float32
    for k, t, shape in (
        ("x", x, (b, hh, ww, c)), ("wq", wq, (c, 3 * c)), ("bq", bq, (3 * c,)),
        ("scale", scale, (num_heads,)), ("wp", wp, (c, c)), ("bp", bp, (c,)), ("g", g, (c,)),
        ("be", be, (c,)), ("bias", bias, (kinds, num_heads, n, n)), ("s", s, (b,)),
    ):
        _check_cuda(k, t, shape, x.device, xdtype if k == "x" else torch.float32)
    if dout is not None:
        _check_cuda("dout", dout, (b, hh, ww, c), x.device, xdtype)


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
    a CPU tensor it runs the plain version. A bf16 x takes the bf16 form
    (`fused_cos_attn_block_backward_bf16`)."""
    args = (x, wq, bq, scale, wp, bp, g, be, bias, s)
    if x.dtype == torch.bfloat16:
        return fused_cos_attn_block_backward_bf16(*args, dout, num_heads, head_dim, window_size,
                                                  eps, shift)
    if x.device.type == "cpu":
        return fused_cos_attn_block_bwd_reference(*args, dout, num_heads, head_dim, window_size,
                                                  eps, shift)
    name = "fused_cos_attn_block_backward"
    _attn_operands(*args, num_heads, head_dim, window_size, shift, True, name, dout)
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


def _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, train, name, dout=None, bf16=False):
    """Shapes, limits, types and placement of the MLP half's operands: x
    (and dout) fp32, or bf16 for the bf16 forms (`bf16`: their gate
    `pn_mlp_bf16_fits`), everything else fp32."""
    b, hh, ww, c = x.shape
    hidden = w1.shape[-1]
    if bf16 and not pn_mlp_bf16_fits(hh, window_size, c, hidden):
        raise ValueError(f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} is outside "
                         f"the bf16 form's limits ({BF16_LIMITS}, hidden a multiple of 4)")
    if not bf16 and not pn_mlp_fits(hh, window_size, c, hidden, train):
        raise ValueError(f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} is outside "
                         "the kernels' limits")
    if b * hh * ww * max(hidden, c) >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    xdtype = torch.bfloat16 if bf16 else torch.float32
    for k, t, shape in (
        ("x", x, (b, hh, ww, c)), ("w1", w1, (c, hidden)), ("b1", b1, (hidden,)),
        ("w2", w2, (hidden, c)), ("b2", b2, (c,)), ("g", g, (c,)), ("be", be, (c,)),
        ("s", s, (b,)),
    ):
        _check_cuda(k, t, shape, x.device, xdtype if k == "x" else torch.float32)
    if dout is not None:
        _check_cuda("dout", dout, (b, hh, ww, c), x.device, xdtype)


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
    (one counted call); on a CPU tensor it runs the plain version. A bf16 x
    takes the bf16 form (`fused_postnorm_mlp_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        return fused_postnorm_mlp_backward_bf16(x, w1, b1, w2, b2, g, be, s, dout, window_size,
                                                eps)
    if x.device.type == "cpu":
        return fused_postnorm_mlp_bwd_reference(x, w1, b1, w2, b2, g, be, s, dout, window_size,
                                                eps)
    name = "fused_postnorm_mlp_backward"
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, True, name, dout)
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
# The bf16 forms: the JAX kernels compute in x.dtype, so a bf16 training step
# runs #11-#14 on bf16 activations (weights cast to bf16 as they go in; the
# biases, temperatures, LayerNorm affine, kind table and DropPath scales
# fp32), each product summed in fp32 and rounded to bf16 where the JAX kernel
# rounds (ops/pallas/fused_block_v2.py:90-268, :426-483), the norms, softmax,
# statistics and gelu in fp32, the parameter gradients in fp32.
# ---------------------------------------------------------------------------


def _cos_attn_bf16_rows(t, wq, bq, scale, wp, bp, bias, b, hh, ww, num_heads, ws, eps):
    """The attention half in bf16 up to its LayerNorm, on rows t (T, C) of
    the rolled frame held in fp32 (bf16 values), with the JAX kernel's
    roundings: qkv = bf16(bf16(t wq) + bf16(bq)); q^ and k^ normalised in fp32
    and rounded before cos = bf16(q^) bf16(k^)^T; P the fp32 softmax of cos
    scale + bias; att = bf16(bf16(P) v); proj = bf16(bf16(att wp) + bf16(bp)).
    Returns (xn, inv) of proj's LayerNorm and what the backward needs."""
    c = t.shape[1]
    qkv = _bf(_bf(t @ _bf(wq)) + _bf(bq.float()))
    q, k, v = (_heads(u, num_heads)
               for u in _to_windows(qkv.reshape(b, hh, ww, 3 * c), ws).chunk(3, dim=-1))
    (qn, qinv), (kn, kinv) = _normalize(q), _normalize(k)
    cos = _bf(qn) @ _bf(kn).transpose(-1, -2)
    p = torch.softmax(cos * scale.float()[:, None, None] + _kind_table(bias, hh // ws, ww // ws),
                      dim=-1)
    att = _bf(_from_windows(_merge_heads(_bf(p) @ v), ws).reshape(-1, c))
    proj = _bf(_bf(att @ _bf(wp)) + _bf(bp.float()))
    return _ln_parts(proj, eps), (p, cos, att, qn, qinv, kn, kinv, v)


def fused_cos_attn_block_bf16_reference(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads,
                                        head_dim, window_size, eps=1e-5, shift=0):
    """#11's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (`_cos_attn_bf16_rows`), then z = bf16(x + s LN1(proj)), one rounding:
    z (B, H, W, C) bf16 from a bf16 x and the fp32 parameters, in x's
    frame."""
    b, hh, ww, c = x.shape
    t = _roll(x.float(), -shift).reshape(-1, c)
    (xn, _), _ = _cos_attn_bf16_rows(t, wq, bq, scale, wp, bp, bias, b, hh, ww, num_heads,
                                     window_size, eps)
    z = t + _row_scale(s, b, hh * ww) * (xn * g.float() + be.float())
    return _roll(z.reshape(b, hh, ww, c), shift).to(torch.bfloat16)


def fused_cos_attn_block_bwd_bf16_reference(x, wq, bq, scale, wp, bp, g, be, bias, s, dout,
                                            num_heads, head_dim, window_size, eps=1e-5, shift=0):
    """#12's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (ops/pallas/fused_block_v2.py:168-268): (dx, dwq, dbq, dscale, dwp, dbp,
    dg, dbe, dbias), dx bf16 and the rest fp32, the forward recomputed as
    `_cos_attn_bf16_rows` rounds it. dproj, datt, dcos = bf16(dS scale), dq,
    dk and dv are rounded to bf16 as operands; dbp sums the fp32 dproj, dbq
    the bf16 dqkv; dscale sums dS cos (cos from the rounded q^ and k^),
    dbias the fp32 dS; the normalisation's backward takes the fp32 q^ and
    k^; dx = bf16(dout + dqkv wq^T)."""
    b, hh, ww, c = x.shape
    ws, nwh, nww, n = window_size, hh // window_size, ww // window_size, window_size**2

    def rows(u):
        return _roll(u.float(), -shift).reshape(b * hh * ww, -1)

    t, do = rows(x), rows(dout)
    (xn, inv), (p, cos, att, qn, qinv, kn, kinv, v) = _cos_attn_bf16_rows(
        t, wq, bq, scale, wp, bp, bias, b, hh, ww, num_heads, ws, eps)
    dy = do * _row_scale(s, b, hh * ww)
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dproj = _ln_backward(dy, xn, inv, g.float())
    dproj_lo = _bf(dproj)
    dwp, dbp = att.T @ dproj_lo, dproj.sum(0)
    datt = _bf(dproj_lo @ _bf(wp).T)
    da = _heads(_to_windows(datt.reshape(b, hh, ww, c), ws), num_heads)
    dv = _bf(_bf(p).transpose(-1, -2) @ da)
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dscale = (ds * cos).sum(dim=(0, 1, 2, 4, 5))
    dcos = _bf(ds * scale.float()[:, None, None])
    dqn, dkn = dcos @ _bf(kn), dcos.transpose(-1, -2) @ _bf(qn)
    dq = _bf((dqn - qn * (qn * dqn).sum(-1, keepdim=True)) * qinv)
    dk = _bf((dkn - kn * (kn * dkn).sum(-1, keepdim=True)) * kinv)
    dbias = torch.zeros(bias.shape[0], num_heads, n, n, dtype=torch.float32, device=x.device)
    dbias.index_add_(0, window_kinds(nwh, nww, bias.shape[0], device=x.device),
                     ds.sum(0).reshape(nwh * nww, num_heads, n, n))
    dqkv = torch.cat([_merge_heads(u) for u in (dq, dk, dv)], dim=-1)
    dqkv = _from_windows(dqkv, ws).reshape(-1, 3 * c)
    dwq, dbq = t.T @ dqkv, dqkv.sum(0)
    dx = _roll((do + dqkv @ _bf(wq).T).reshape(b, hh, ww, c), shift).to(torch.bfloat16)
    return dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias


def _pn_mlp_bf16_rows(t, w1, b1, w2, b2, eps):
    """The MLP half in bf16 up to its LayerNorm, on rows t (T, C) held in fp32
    (bf16 values), with the JAX kernel's roundings: h = bf16(bf16(t w1) +
    bf16(b1)), hg = bf16(gelu(h)), m = bf16(bf16(hg w2) + bf16(b2)). Returns
    ((xn, inv) of m's LayerNorm, h, hg)."""
    h = _bf(_bf(t @ _bf(w1)) + _bf(b1.float()))
    hg = _bf(F.gelu(h, approximate="none"))
    m = _bf(_bf(hg @ _bf(w2)) + _bf(b2.float()))
    return _ln_parts(m, eps), h, hg


def fused_postnorm_mlp_bf16_reference(x, w1, b1, w2, b2, g, be, s, window_size, eps=1e-5):
    """#13's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (`_pn_mlp_bf16_rows`), then out = bf16(x + s LN2(m)), one rounding: out
    (B, H, W, C) bf16 from a bf16 x and the fp32 parameters."""
    b, hh, ww, c = x.shape
    t = x.float().reshape(-1, c)
    (xn, _), _, _ = _pn_mlp_bf16_rows(t, w1, b1, w2, b2, eps)
    out = t + _row_scale(s, b, hh * ww) * (xn * g.float() + be.float())
    return out.reshape(x.shape).to(torch.bfloat16)


def fused_postnorm_mlp_bwd_bf16_reference(x, w1, b1, w2, b2, g, be, s, dout, window_size,
                                          eps=1e-5):
    """#14's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (ops/pallas/fused_block_v2.py:441-483): (dx, dw1, db1, dw2, db2, dg,
    dbe), dx bf16 and the rest fp32, h, hg and m recomputed as the forward
    rounds them. dm and dh are rounded to bf16 as operands while db2 and db1
    sum the fp32 dm and dh; dx = bf16(dout + bf16(dh) w1^T)."""
    b, hh, ww, c = x.shape
    t, do = x.float().reshape(-1, c), dout.float().reshape(-1, c)
    (xn, inv), h, hg = _pn_mlp_bf16_rows(t, w1, b1, w2, b2, eps)
    dy = do * _row_scale(s, b, hh * ww)
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dm = _ln_backward(dy, xn, inv, g.float())
    dm_lo = _bf(dm)
    dw2, db2 = hg.T @ dm_lo, dm.sum(0)
    dh = (dm_lo @ _bf(w2).T) * _gelu_grad(h)
    dh_lo = _bf(dh)
    dw1, db1 = t.T @ dh_lo, dh.sum(0)
    dx = (do + dh_lo @ _bf(w1).T).reshape(x.shape).to(torch.bfloat16)
    return dx, dw1, db1, dw2, db2, dg, dbe


def fused_cos_attn_block_bf16(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                              window_size, eps=1e-5, shift=0):
    """#11's bf16 form: z (B, H, W, C) bf16 of a bf16 x from the fp32
    parameters, as `fused_cos_attn_block_bf16_reference` computes it. On a
    CUDA tensor it casts wq and wp to bf16 and launches `trr_cos_attn_fwd_bf16`
    (one counted call, four launches: qkv, the cosine window attention, proj,
    the post-norm row pass); on a CPU tensor it runs the plain version.
    Outside `cos_attn_bf16_fits` a CUDA tensor raises."""
    if x.device.type == "cpu":
        return fused_cos_attn_block_bf16_reference(x, wq, bq, scale, wp, bp, g, be, bias, s,
                                                   num_heads, head_dim, window_size, eps, shift)
    name = "fused_cos_attn_block_bf16"
    _attn_operands(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size,
                   shift, True, name, bf16=True)
    wq, wp = wq.to(torch.bfloat16), wp.to(torch.bfloat16)
    _check_aligned(name, x=x, wq=wq, bq=bq, wp=wp, bp=bp, g=g, be=be, bias=bias)
    b, hh, ww, c = x.shape
    z = torch.empty_like(x)
    if z.numel() == 0:
        return z
    T = b * hh * ww  # the stages pass qkv, att and proj through (T, 3C), (T, C), (T, C)
    qkv, att, proj = (torch.empty((T, k), device=x.device, dtype=torch.bfloat16)
                      for k in (3 * c, c, c))
    fused_cos_attn_block_bf16.launches += 1
    _launch(LIB, "trr_cos_attn_fwd_bf16", x.device,
            *(t.data_ptr() for t in (x, wq, bq, scale, wp, bp, g, be, bias, s, qkv, att, proj,
                                     z)),
            b, hh, ww, c, num_heads, bias.shape[0], shift, eps)
    return z


def _weight_grad_bf16(a, bmat, sums_f32=None, sums_bf16=None):
    """(A^T B, column sums of the fp32 rows B was rounded from: sums_f32, or
    the bf16 sums_bf16) over the T rows of a (T, M) and bmat (T, N) bf16, on
    the bf16 tensor cores (csrc/wgrad_bf16.cuh), partial sums added in a
    fixed order."""
    t, m, nn = a.shape[0], a.shape[1], bmat.shape[1]
    part = torch.empty(_part_floats_bf16(t, m, nn), device=a.device, dtype=torch.float32)
    out = torch.empty(m * nn + nn, device=a.device, dtype=torch.float32)
    _launch("fused_block_train", "trr_weight_grad_bf16", a.device, a.data_ptr(), bmat.data_ptr(),
            t, m, nn, 0 if sums_f32 is None else sums_f32.data_ptr(),
            0 if sums_bf16 is None else sums_bf16.data_ptr(), part.data_ptr(), out.data_ptr())
    return _split_grad(out, m, nn)


def fused_cos_attn_block_backward_bf16(x, wq, bq, scale, wp, bp, g, be, bias, s, dout, num_heads,
                                       head_dim, window_size, eps=1e-5, shift=0):
    """#12's bf16 form: (dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias), dx
    bf16 and the rest fp32, from the bf16 x and dout, as
    `fused_cos_attn_block_bwd_bf16_reference` computes them. On a CUDA tensor
    it launches `trr_cos_attn_bwd_bf16` (the forward's stages again, the
    post-norm backward rows, datt, the bf16 cosine window-attention backward
    stage, dx), then the bf16 weight gradients, the row sums and the
    bias-kind kernel of `csrc/fused_block_train.cu` (one counted call); on a
    CPU tensor it runs the plain version."""
    args = (x, wq, bq, scale, wp, bp, g, be, bias, s)
    if x.device.type == "cpu":
        return fused_cos_attn_block_bwd_bf16_reference(*args, dout, num_heads, head_dim,
                                                       window_size, eps, shift)
    name = "fused_cos_attn_block_backward_bf16"
    _attn_operands(*args, num_heads, head_dim, window_size, shift, True, name, dout, bf16=True)
    wqh, wph = wq.to(torch.bfloat16), wp.to(torch.bfloat16)
    _check_aligned(name, x=x, dout=dout, wq=wqh, bq=bq, wp=wph, bp=bp, g=g)
    b, hh, ww, c = x.shape
    T, dev, kinds = b * hh * ww, x.device, bias.shape[0]
    nwin = b * (hh // window_size) * (ww // window_size)

    def new(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device=dev, dtype=dtype)

    qkv, dqkv, att, proj, dproj, datt = new(T, 3 * c), new(T, 3 * c), *(new(T, c) for _ in range(4))
    dproj32, dx = new(T, c, dtype=torch.float32), torch.empty_like(x)
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c, dtype=torch.float32)
    dscale_part = new(nwin, num_heads, dtype=torch.float32)
    dS = new(nwin, num_heads, TILE, TILE, dtype=torch.float32)
    fused_cos_attn_block_backward_bf16.launches += 1
    _launch(LIB, "trr_cos_attn_bwd_bf16", dev,
            *(t.data_ptr() for t in (x, dout, wqh, bq, scale, wph, bp, g, s, bias, qkv, att, proj,
                                     dproj, dproj32, datt, ln_part, dqkv, dS, dscale_part, dx)),
            b, hh, ww, c, num_heads, kinds, shift, eps)
    dwq, dbq = _weight_grad_bf16(x.view(T, c), dqkv, sums_bf16=dqkv)
    dwp, dbp = _weight_grad_bf16(att, dproj, sums_f32=dproj32)
    dg, dbe = _sum_rows(ln_part).split(c)
    dscale = _sum_rows(dscale_part)
    dbias = new(kinds, num_heads, TILE, TILE, dtype=torch.float32)
    _launch("fused_block_train", "trr_dbias", dev, dS.data_ptr(), b, hh // window_size,
            ww // window_size, num_heads, kinds, dbias.data_ptr())
    return dx, dwq, dbq, dscale, dwp, dbp, dg, dbe, dbias


def fused_postnorm_mlp_bf16(x, w1, b1, w2, b2, g, be, s, window_size, eps=1e-5):
    """#13's bf16 form: out (B, H, W, C) bf16 of a bf16 x from the fp32
    parameters, as `fused_postnorm_mlp_bf16_reference` computes it. On a
    CUDA tensor it casts w1 and w2 to bf16 and launches `trr_pn_mlp_fwd_bf16`
    (one counted call, three launches: fc1 + gelu, fc2, the post-norm row
    pass); on a CPU tensor it runs the plain version. Outside
    `pn_mlp_bf16_fits` a CUDA tensor raises."""
    if x.device.type == "cpu":
        return fused_postnorm_mlp_bf16_reference(x, w1, b1, w2, b2, g, be, s, window_size, eps)
    name = "fused_postnorm_mlp_bf16"
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, True, name, bf16=True)
    w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    _check_aligned(name, x=x, w1=w1, b1=b1, w2=w2, b2=b2, g=g, be=be)
    b, hh, ww, c = x.shape
    hidden, T = w1.shape[1], b * hh * ww
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    hg, m = (torch.empty((T, k), device=x.device, dtype=torch.bfloat16) for k in (hidden, c))
    fused_postnorm_mlp_bf16.launches += 1
    _launch(LIB, "trr_pn_mlp_fwd_bf16", x.device,
            *(t.data_ptr() for t in (x, w1, b1, w2, b2, g, be, s, hg, m, out)),
            b, hh, ww, c, hidden, eps)
    return out


def fused_postnorm_mlp_backward_bf16(x, w1, b1, w2, b2, g, be, s, dout, window_size, eps=1e-5):
    """#14's bf16 form: (dx, dw1, db1, dw2, db2, dg, dbe), dx bf16 and the
    rest fp32, from the bf16 x and dout, as
    `fused_postnorm_mlp_bwd_bf16_reference` computes them. On a CUDA tensor
    it launches `trr_pn_mlp_bwd_bf16` (fc1 + gelu and fc2 again, the
    post-norm backward rows, h and dh, dx), then the bf16 weight gradients
    and the row sums (one counted call); on a CPU tensor it runs the plain
    version."""
    if x.device.type == "cpu":
        return fused_postnorm_mlp_bwd_bf16_reference(x, w1, b1, w2, b2, g, be, s, dout,
                                                     window_size, eps)
    name = "fused_postnorm_mlp_backward_bf16"
    _mlp_operands(x, w1, b1, w2, b2, g, be, s, window_size, True, name, dout, bf16=True)
    w1h, w2h = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    _check_aligned(name, x=x, dout=dout, w1=w1h, b1=b1, w2=w2h, b2=b2, g=g)
    b, hh, ww, c = x.shape
    hidden, dev, T = w1.shape[1], x.device, b * hh * ww

    def new(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device=dev, dtype=dtype)

    hg, dh, m, dm = new(T, hidden), new(T, hidden), new(T, c), new(T, c)
    dh32, dm32 = new(T, hidden, dtype=torch.float32), new(T, c, dtype=torch.float32)
    dx, ln_part = torch.empty_like(x), new(math.ceil(T / TC_ROWS), 2 * c, dtype=torch.float32)
    fused_postnorm_mlp_backward_bf16.launches += 1
    _launch(LIB, "trr_pn_mlp_bwd_bf16", dev,
            *(t.data_ptr() for t in (x, dout, w1h, b1, w2h, b2, g, s, hg, m, dm, dm32, dh, dh32,
                                     dx, ln_part)),
            b, hh, ww, c, hidden, eps)
    dw2, db2 = _weight_grad_bf16(hg, dm, sums_f32=dm32)
    dw1, db1 = _weight_grad_bf16(x.view(T, c), dh, sums_f32=dh32)
    dg, dbe = _sum_rows(ln_part).split(c)
    return dx, dw1, db1, dw2, db2, dg, dbe


fused_cos_attn_block_bf16.launches = 0
fused_cos_attn_block_backward_bf16.launches = 0
fused_postnorm_mlp_bf16.launches = 0
fused_postnorm_mlp_backward_bf16.launches = 0


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


class _CosAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                window_size, eps, shift):
        args = (x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim, window_size, eps,
                shift)
        if x.dtype == torch.bfloat16:
            z = fused_cos_attn_block_bf16(*args)
        elif x.device.type == "cpu":
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
    run their plain versions. A bf16 x runs the bf16 forms (z and dx in
    bf16, the parameter gradients in fp32)."""
    return _CosAttn.apply(x, wq, bq, scale, wp, bp, g, be, bias, s, num_heads, head_dim,
                          window_size, eps, shift)


fused_cos_attn_block.launches = 0


class _PostnormMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, be, s, window_size, eps):
        args = (x, w1, b1, w2, b2, g, be, s, window_size, eps)
        if x.dtype == torch.bfloat16:
            out = fused_postnorm_mlp_bf16(*args)
        elif x.device.type == "cpu":
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
    plain versions. A bf16 x runs the bf16 forms (out and dx in bf16, the
    parameter gradients in fp32)."""
    return _PostnormMlp.apply(x, w1, b1, w2, b2, g, be, s, window_size, eps)


fused_postnorm_mlp.launches = 0
