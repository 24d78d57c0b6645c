"""Fused pre-LN Swin blocks: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of the JAX package's ops/pallas/fused_block.py:

  fused_attn_block : z   = x + s[b] * proj(window-MHSA(qkv(LN1(x))))
  fused_ln_mlp     : out = x + s[b] * fc2(gelu_erf(fc1(LN2(x))))
  fused_attn_block_train : the same z, a torch.autograd.Function whose
      forward (TPU kernel #9) saves the softmax P and the attention output,
      and whose backward (#10, `fused_attn_block_train_backward`) computes
      every gradient from them (the saved-P backward);
  fused_swin_block_train : out = fused_ln_mlp(fused_attn_block(x)) with s1
      and s2, a torch.autograd.Function whose forward saves P, the attention
      output and z, and whose backward computes every gradient from them; on
      a bf16 x it computes as the JAX kernel does in bf16 (its bf16 forms,
      counted as `fused_swin_block_train_bf16` and
      `fused_swin_block_train_backward_bf16`); `fused_ln_mlp` does too (its
      bf16 forms `fused_ln_mlp_bf16` and `fused_ln_mlp_backward_bf16`, HAT's
      MLP halves in a bf16 step), and so does `fused_attn_block` at 12x12
      windows (`fused_attn_block_bf16` and `fused_attn_block_backward_bf16`,
      SRFormerV2's Swin blocks in a bf16 step).

`fused_attn_block` and `fused_ln_mlp` are torch.autograd.Functions whose
backwards recompute from x: #1's (TPU kernel #6,
`fused_attn_block_backward`) rebuilds LN, qkv and the softmax, #2's (#7)
LN and fc1.

`s` is the per-sample DropPath keep scale (ones at eval). Layout contract
as in ops/window_attention.py: x is NHWC (B, H, W, C) with H and W
multiples of window_size, weights are (in, out), the bias table is
(K, nh, n, n). Heads of at most 32 channels, in fp32 (the whole training
block, the MLP half and the attention half at 12x12 windows also in bf16,
the attention half's training form raising on it). The attention half's
forward takes 8x8 windows (n = 64) and 12x12 (n = 144, SRFormerV2's), both
on the tensor-core stages of `csrc/block_fwd.cuh`, which the MLP half runs
too; its backwards (`csrc/attn_block_staged.cu`) and its training form take
both, the whole training block (#4/#5) 8x8 only. The cyclic shift of a
shifted block is either done by the caller (roll x, unroll z; the JAX
package's contract) or, with `shift=s`, by the kernels' indexing. The MLP
half is per-token and needs no roll; its backward takes rows of up to
MLP_ROWS_MAX_C (320) channels, past ROWS_MAX_C (256) on a split rows stage
(DRCT's C 276 and 308), counted apart as `launches_c320`.

For a CUDA tensor each wrapper launches its kernel in
`csrc/fused_block.cu`, `csrc/attn_block_staged.cu` or
`csrc/fused_block_train.cu`; for a CPU tensor it runs its plain version
(`*_reference`); anything else raises.
`fused_mlp_supported` gates `fused_ln_mlp` for archs whose attention half
is their own (HAT's HAB and OCAB).
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.ops.window_attention import (
    SMEM_LIMIT,
    V_LD,
    WINDOW,
    _bf,
    _check_cuda,
    attn_bwd_tc_smem_bytes,
    attn_fwd_tc_smem_bytes,
    fused_window_mhsa_reference,
    kind_windows,
    window_kinds,
)

# The tensor-core engine of the training backwards (csrc/tc_gemm.cuh): a ring
# of TC_STAGES operand chunks TC_K deep ([row][k] rows TC_LD floats apart),
# TC_SPLIT buffers of a weight chunk's TF32 halves, block tiles of TC_ROWS
# tokens; the weight gradients take chunks ATB_K deep on ATB_STAGES stages.
# A rows_kernel tile spans a row of at most ROWS_MAX_C channels, a
# ln_rows_kernel row (the forwards' LayerNorm) at most LN_MAX_C.
TC_STAGES, TC_K, TC_LD, TC_SPLIT, TC_ROWS = 4, 16, 20, 3, 128
ATB_K, ATB_STAGES = 32, 3
ROWS_MAX_C, LN_MAX_C = 256, 512
# the MLP half's backward (#7, fp32 and bf16) also takes rows of up to
# MLP_ROWS_MAX_C channels (DRCT's 276 and 308): past ROWS_MAX_C its rows
# stage splits into products of ROWS_HALF and C - ROWS_HALF columns into a
# (T, C) fp32 scratch, then the LN backward over whole rows
# (csrc/tc_rows_bf16.cuh ln_bwd_rows_kernel)
MLP_ROWS_MAX_C, ROWS_HALF = 320, 160
# the whole block's backward (#5) is held to the widths checked on the card
SWIN_BLOCK_MAX_C = 192
# the windows the attention half takes (csrc/attn_block_staged.cu), and its
# bf16 forms (csrc/fused_block_train.cu: SRFormerV2's)
STAGED_WINDOWS = (12, 8)
BF16_ATTN_WINDOW = 12
# the bf16 engine (csrc/tc_gemm_bf16.cuh): chunks BF_K bf16 deep, staged
# [row][k] rows BF_LD bf16 apart
BF_K, BF_LD = 32, 40
# the bf16 weight gradients (csrc/wgrad_bf16.cuh): chunks of WG_K tokens on a
# ring of WG_STAGES stages, block tiles of WG_ROWS rows of M by one of
# WG_COLS columns of N, token ranges for a wave of WG_WAVE_BLOCKS blocks,
# the separate bias-sum sources in partial rows of WG_SUM_TOKENS tokens
WG_K, WG_STAGES, WG_ROWS, WG_WAVE_BLOCKS, WG_SUM_TOKENS = 64, 4, 128, 132, 512
WG_COLS = (64, 128, 192, 256)
# #6's bf16 window attention (csrc/attn_group_bf16.cuh): GROUP_WINDOWS
# windows of one kind a block, GROUP_THREADS threads, head rows GROUP_LD
# bf16 apart, P / dS rows GROUP_LP apart, at n GROUP_N
GROUP_N, GROUP_WINDOWS, GROUP_THREADS, GROUP_LD, GROUP_LP = 144, 8, 288, 40, 152
# #1's bf16 window attention (attn_group_fwd_bf16_kernel): blocks a SM, and
# so the group size that fills two waves (window_attention.group_windows)
GROUP_FWD_BLOCKS = 1


def attn_block_smem_bytes(channels: int, window_size: int = WINDOW) -> int:
    """The largest shared memory of the attention half's forward kernels
    (csrc/block_fwd.cuh) at 8x8 or 12x12 windows: qkv on linear_kernel, the
    window attention on mma.sync, the residual product over a row of
    `channels`."""
    return max(linear_smem_bytes(), attn_fwd_tc_smem_bytes(window_size * window_size),
               residual_smem_bytes(channels))


def ln_mlp_smem_bytes(channels: int) -> int:
    """The largest shared memory of the MLP half's forward kernels
    (csrc/block_fwd.cuh): fc1 on linear_kernel (any hidden width), the
    residual product over a row of `channels`."""
    return max(linear_smem_bytes(), residual_smem_bytes(channels))


def attn_rows_bwd_tc_smem_bytes(window_size: int) -> int:
    """Shared memory of #6's tensor-core window-attention stage
    (`attn_bwd_tc_smem_bytes` with its att rows)."""
    return attn_bwd_tc_smem_bytes(window_size**2, att=True)


def attn_staged_bwd_smem_bytes(channels: int, num_heads: int, window_size: int) -> int:
    """The largest shared memory of the recompute backward's kernels (#6):
    the engine's per-token kernels (qkv; datt and the LN1 backward over a
    row of `channels`) and the window attention."""
    return max(linear_smem_bytes(), rows_smem_bytes(channels),
               attn_rows_bwd_tc_smem_bytes(window_size))


def attn_train_bwd_smem_bytes(channels: int, num_heads: int, window_size: int) -> int:
    """The largest shared memory of the saved-P backward's kernels (#10): the
    engine's per-token kernels as #6's, and the saved-P form of the
    tensor-core window attention (no att rows, one exchange)."""
    return max(linear_smem_bytes(), rows_smem_bytes(channels),
               attn_bwd_tc_smem_bytes(window_size**2, att=False, saved=True))


def attn_block_fits(h, w, window_size, channels, num_heads) -> bool:
    """The attention half's forward (#1): 8x8 or 12x12 windows on the
    tensor-core stages, window-aligned dims, heads of at most 32 channels, a
    LayerNorm row of at most LN_MAX_C channels, each plan within one thread
    block's shared memory."""
    if window_size not in STAGED_WINDOWS or h % window_size or w % window_size:
        return False
    if channels % num_heads or channels // num_heads > V_LD or channels > LN_MAX_C:
        return False
    return attn_block_smem_bytes(channels, window_size) <= SMEM_LIMIT


def tc_rows_fit(channels: int) -> bool:
    """Rows the engine's per-token kernels (csrc/tc_rows.cuh) take: one
    rows_kernel tile spans at most ROWS_MAX_C channels, and rows move in
    16-byte pieces."""
    return channels <= ROWS_MAX_C and channels % 4 == 0


def attn_block_bwd_fits(h, w, window_size, channels, num_heads) -> bool:
    """The attention half's recompute backward (#6) as well as its forward:
    rows the engine takes (`tc_rows_fit`), each plan within one thread
    block's shared memory."""
    if not (attn_block_fits(h, w, window_size, channels, num_heads)
            and tc_rows_fit(channels)):
        return False
    return attn_staged_bwd_smem_bytes(channels, num_heads, window_size) <= SMEM_LIMIT


def attn_block_train_fits(h, w, window_size, channels, num_heads, batch=1) -> bool:
    """The attention half's training form (#9 and #10): as the forward, 8x8
    or 12x12 windows and heads of at most 32 channels, rows the engine takes
    (`tc_rows_fit`), the saved-P backward's plans within one thread block's
    shared memory, and P's batch * H * W * heads * n entries within a 32-bit
    index."""
    if not (attn_block_fits(h, w, window_size, channels, num_heads)
            and tc_rows_fit(channels)):
        return False
    if batch * h * w * num_heads * window_size**2 >= 2**31:
        return False
    return attn_train_bwd_smem_bytes(channels, num_heads, window_size) <= SMEM_LIMIT


def ln_mlp_fits(h, window_size, channels) -> bool:
    """The MLP half's forward (#2): H a multiple of the caller's rows, a
    LayerNorm row of at most LN_MAX_C channels, any hidden width."""
    if h % window_size or channels > LN_MAX_C:
        return False
    return ln_mlp_smem_bytes(channels) <= SMEM_LIMIT


def _ring_bytes(stage_floats: int, stages: int = TC_STAGES) -> int:
    """Shared memory of an operand ring: the stages and two mbarriers each."""
    return stages * (4 * stage_floats + 16)


def rows_tile_cols(channels: int) -> int:
    """Columns of a rows_kernel tile: the least of 64, 128, 192 and 256 that
    spans a row of `channels`."""
    return next(n for n in (64, 128, 192, 256) if channels <= n)


def _split_bytes(cols: int, depth: int = TC_K) -> int:
    """The TC_SPLIT buffers of a (cols, depth) chunk's TF32 hi and lo tiles."""
    return 4 * TC_SPLIT * 2 * cols * depth


def _wg_bytes(cols: int) -> int:
    """A per-token kernel's buffers: the split buffers, and a ring of a
    (128, 16) token chunk and a raw (cols, 16) weight chunk ([n][k] rows of
    20 floats, or [k][n] rows of cols + 8) a stage."""
    raw = max(cols * TC_LD, TC_K * (cols + 8))
    return _split_bytes(cols) + _ring_bytes(TC_ROWS * TC_LD + raw)


def rows_smem_bytes(channels: int) -> int:
    """Shared memory of rows_kernel (csrc/tc_rows.cuh)."""
    return _wg_bytes(rows_tile_cols(channels))


def linear_smem_bytes() -> int:
    """Shared memory of linear_kernel (csrc/tc_rows.cuh) at its widest,
    128-column tile: a per-token kernel's buffers."""
    return _wg_bytes(128)


def residual_tile_cols(channels: int) -> int:
    """Columns of a linear_kernel tile over a row of `channels` outputs,
    whatever its epilogue (csrc/tc_rows.cuh `linear_cols`; the residual
    products' rows are the block's): 64 or 128 where one tile spans the
    row, 96 for rows of 129-192 (two tiles), else 128."""
    return 64 if channels <= 64 else 128 if channels <= 128 else 96 if channels <= 192 else 128


def residual_smem_bytes(channels: int) -> int:
    """Shared memory of linear_kernel over a row of `channels` outputs (its
    residual epilogue's rows): a per-token kernel's buffers at its column
    tile."""
    return _wg_bytes(residual_tile_cols(channels))


def mlp_hidden_smem_bytes() -> int:
    """Shared memory of mlp_hidden_kernel: gelu'(h) of its (128, 128) tile
    besides a per-token kernel's buffers."""
    return 4 * TC_ROWS * 128 + _wg_bytes(128)


def weight_grad_smem_bytes() -> int:
    """Shared memory of atb_kernel: the split buffers of a (128, 32) chunk,
    then a 3-stage ring of two (32, 128 + 8) token-major chunks a stage."""
    return (_split_bytes(TC_ROWS, ATB_K)
            + _ring_bytes(2 * ATB_K * (TC_ROWS + 8), ATB_STAGES))


def _core_bytes(cols: int) -> int:
    """The TC_SPLIT core-tile buffers of a bf16 (cols, BF_K) chunk."""
    return 4 * TC_SPLIT * cols * BF_K // 2


def wg_bf16_bytes(cols: int) -> int:
    """Shared memory of a bf16 per-token kernel (csrc/tc_rows_bf16.cuh) at
    `cols` columns: the core-tile buffers, then a ring of a (128, BF_K) token
    chunk and a raw (cols, BF_K) weight chunk a stage, two bf16 a float."""
    raw = max(cols * BF_LD, BF_K * (cols + 8))
    return _core_bytes(cols) + _ring_bytes((TC_ROWS * BF_LD + raw) // 2)


def rows_bf16_smem_bytes(channels: int) -> int:
    """Shared memory of rows_bf16_kernel: its buffers, or the (128, BN + 8)
    fp32 dy tile and the 8 warps' column sums they are reused for."""
    cols = rows_tile_cols(channels)
    return max(wg_bf16_bytes(cols), 4 * (TC_ROWS * (cols + 8) + 2 * 8 * channels))


def weight_grad_bf16_cols(n: int) -> int:
    """Columns of a wg_bf16_kernel tile over N (csrc/wgrad_bf16.cuh
    wg_cols): the one of WG_COLS whose tiles copy the fewest bytes a chunk,
    n-tiles x (WG_ROWS + BN), the wider at a tie."""
    return min(reversed(WG_COLS), key=lambda bn: -(-n // bn) * (WG_ROWS + bn))


def weight_grad_bf16_smem_bytes(n: int) -> int:
    """Shared memory of wg_bf16_kernel over N columns: a ring of WG_STAGES
    stages of a (WG_K, WG_ROWS) A tile and a (WG_K, BN) B tile in bf16."""
    return _ring_bytes(WG_K * (WG_ROWS + weight_grad_bf16_cols(n)) // 2, WG_STAGES)


def weight_grad_bf16_plan(t: int, m: int, n: int) -> dict:
    """How wg_bf16_kernel cuts a (T, M)^T (T, N) product (csrc/wgrad_bf16.cuh
    wg_plan): tile columns bn, m and n tiles, the tokens of a range (a
    multiple of WG_K, ranges enough for one wave of WG_WAVE_BLOCKS blocks)
    and the ranges z."""
    bn = weight_grad_bf16_cols(n)
    nm, nn = -(-m // WG_ROWS), -(-n // bn)
    want = 1 if nm * nn >= WG_WAVE_BLOCKS else WG_WAVE_BLOCKS // (nm * nn)
    chunk = max(-(-(-(-t // want)) // WG_K) * WG_K, WG_K)
    return {"bn": bn, "nm": nm, "nn": nn, "chunk": chunk, "z": -(-t // chunk)}


def weight_grad_bf16_sum_rows(t: int, plan: dict, from_b: bool) -> int:
    """Partial rows of a product's bias sums: a (range, m-tile) row each
    where B is the source, else one a WG_SUM_TOKENS tokens."""
    return plan["z"] * plan["nm"] if from_b else -(-t // WG_SUM_TOKENS)


def weight_grad_bf16_part_floats(t: int, m: int, n: int) -> int:
    """Floats of a bf16 weight gradient's partial sums, either source of its
    bias sums (csrc/wgrad_bf16.cuh wg_part_floats)."""
    plan = weight_grad_bf16_plan(t, m, n)
    rows = max(weight_grad_bf16_sum_rows(t, plan, True), weight_grad_bf16_sum_rows(t, plan, False))
    return plan["z"] * m * n + rows * n


def attn_group_smem_bytes() -> int:
    """Shared memory of #6's bf16 window attention (csrc/attn_group_bf16.cuh
    attn_group_bwd_bf16_kernel): the threads' dbias sums (n * n fp32), two
    windows' rooms of n bf16 head rows each of q, k, v and dA, and the bf16
    P / dS tile."""
    n = GROUP_N
    return 4 * n * n + 2 * 2 * 4 * n * GROUP_LD + 2 * n * GROUP_LP


def attn_group_fwd_smem_bytes() -> int:
    """Shared memory of #1's bf16 window attention (csrc/attn_group_bf16.cuh
    attn_group_fwd_bf16_kernel): two windows' rooms of n bf16 head rows
    each of q, k and v, a byte a staged row."""
    return 2 * 2 * 3 * GROUP_N * GROUP_LD + 3 * GROUP_N


def linear_tma_smem_bytes() -> int:
    """Shared memory of #1 bf16's TMA-fed products (csrc/linear_tma_bf16.cuh):
    1,024 bytes of alignment slack, the resident (128, 256) W^T tile and
    four (128, 64) A chunks in bf16, the (128, 136) bf16 epilogue tile, nine
    mbarriers."""
    return 1024 + (256 // 64 + 4) * 128 * 64 * 2 + 2 * 128 * 136 + 8 * (2 * 4 + 1)


def attn_dbias_groups(b: int, nwh: int, nww: int, kinds: int,
                      windows: int = GROUP_WINDOWS) -> list:
    """The groups of windows that the grouped bf16 window attention walks
    (#6's, GROUP_WINDOWS a group; #1's and #8's, `windows` a group), in
    group order: (kind, [(sample, window row, window column), ...]) with
    each kind's windows in (sample, row, column) order, the last group of a
    kind taking the rest (csrc/attn_group_bf16.cuh attn_groups)."""
    groups = []
    for kind in range(kinds):
        wins = kind_windows(b, nwh, nww, kinds, kind)
        groups += [(kind, wins[i:i + windows]) for i in range(0, len(wins), windows)]
    return groups


def attn_block_bf16_smem_bytes(channels: int) -> int:
    """The largest shared memory of the bf16 attention half's kernels (#1 and
    #6's bf16 forms) at 12x12 windows: qkv and proj on linear_bf16_kernel,
    datt and the LN1 backward on rows_bf16_kernel, the two weight gradients,
    the window attention's forward and #6's (n 144)."""
    return max(wg_bf16_bytes(residual_tile_cols(3 * channels)),
               wg_bf16_bytes(residual_tile_cols(channels)), rows_bf16_smem_bytes(channels),
               weight_grad_bf16_smem_bytes(3 * channels), weight_grad_bf16_smem_bytes(channels),
               attn_group_fwd_smem_bytes(), attn_group_smem_bytes(), linear_tma_smem_bytes())


def attn_block_bf16_fits(h, w, window_size, channels, num_heads) -> bool:
    """#1 and #6's bf16 forms: 12x12 windows (SRFormerV2's), window-aligned
    dims, heads of at most 32 channels, rows the bf16 engine takes (C <=
    ROWS_MAX_C, a multiple of 4) and each plan within one thread block's
    shared memory."""
    ws = BF16_ATTN_WINDOW
    if window_size != ws or h % ws or w % ws:
        return False
    if channels % num_heads or channels // num_heads > V_LD or not tc_rows_fit(channels):
        return False
    return attn_block_bf16_smem_bytes(channels) <= SMEM_LIMIT


def ln_mlp_bwd_fits(channels: int, hidden: int) -> bool:
    """The MLP half's backward (#7, csrc/fused_block_train.cu): a row of at
    most MLP_ROWS_MAX_C channels (up to ROWS_MAX_C one rows_kernel tile
    spans it, for the LN backward's row sums; past it the split rows stage,
    its products at most ROWS_HALF columns wide, the LN backward a row a
    warp), C and hidden in multiples of 4 (16-byte copies), and each
    kernel's plan within one thread block's shared memory."""
    if channels > MLP_ROWS_MAX_C or channels % 4 or hidden % 4:
        return False
    rows = rows_smem_bytes(channels if channels <= ROWS_MAX_C else ROWS_HALF)
    return max(rows, mlp_hidden_smem_bytes(), weight_grad_smem_bytes()) <= SMEM_LIMIT


def fused_mlp_supported(h: int, w: int, rows: int, channels: int, hidden: int,
                        train: bool = False) -> bool:
    """Gate for fused_ln_mlp alone (archs whose attention half differs but
    whose pre-LN MLP matches): `rows` divides H (archs pass their window
    size), the forward kernel's plan fits and, in training, the backward's.
    TRAINNER_FUSED_BLOCK=0 and TRAINNER_FUSED_ATTN=0 are the off switches."""
    if os.environ.get("TRAINNER_FUSED_BLOCK", "1") == "0":
        return False
    if os.environ.get("TRAINNER_FUSED_ATTN", "1") == "0":
        return False
    if rows <= 0 or not ln_mlp_fits(h, rows, channels):
        return False
    return not train or ln_mlp_bwd_fits(channels, hidden)


def fused_block_supported(
    h: int, w: int, window_size: int, channels: int, num_heads: int, hidden: int
) -> bool:
    """Gate for a Swin block's fused branch (SwinIR's, SRFormerV2's):
    window-aligned dims, 8x8 or 12x12 windows, heads of at most 32 channels,
    and both halves' shared-memory plans within one thread block's limit.
    TRAINNER_FUSED_BLOCK=0 and TRAINNER_FUSED_ATTN=0 are the off switches."""
    if os.environ.get("TRAINNER_FUSED_BLOCK", "1") == "0":
        return False
    if os.environ.get("TRAINNER_FUSED_ATTN", "1") == "0":
        return False
    return attn_block_fits(h, w, window_size, channels, num_heads) and ln_mlp_fits(
        h, window_size, channels
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


def _sum_rows(part):
    """Column sums of part (S, L), the rows added in order."""
    out = torch.empty(part.shape[1], device=part.device, dtype=torch.float32)
    _launch("fused_block_train", "trr_sum_rows", part.device, part.data_ptr(), part.shape[0],
            part.shape[1], out.data_ptr())
    return out


def _part_floats(t: int, m: int, n: int) -> int:
    """Floats of the partial sums of one weight gradient (atb_kernel)."""
    from trainner_redux_tpu_torch.ops import cuda_build

    return cuda_build.library("fused_block_train").trr_weight_grad_part_floats(t, m, n)


def _part_floats_bf16(t: int, m: int, n: int) -> int:
    """Floats of the partial sums of one bf16 weight gradient
    (csrc/wgrad_bf16.cuh)."""
    from trainner_redux_tpu_torch.ops import cuda_build

    return cuda_build.library("fused_block_train").trr_weight_grad_bf16_part_floats(t, m, n)


def _split_grad(buf, m: int, n: int):
    """(dW (m, n), db (n)) of a weight gradient's m * n + n floats."""
    return buf[: m * n].view(m, n), buf[m * n :]


def _weight_grad(a, bmat):
    """(A^T B, column sums of B) over the T rows of a (T, M) and bmat (T, N),
    on the tensor cores in 3xTF32: partial sums over token chunks, added in
    a fixed order."""
    t, m, nn = a.shape[0], a.shape[1], bmat.shape[1]
    part = torch.empty(_part_floats(t, m, nn), device=a.device, dtype=torch.float32)
    out = torch.empty(m * nn + nn, device=a.device, dtype=torch.float32)
    _launch("fused_block_train", "trr_weight_grad", a.device, a.data_ptr(), bmat.data_ptr(), t, m,
            nn, part.data_ptr(), out.data_ptr())
    return _split_grad(out, m, nn)


def _check_aligned(name: str, **tensors) -> None:
    """The engine's kernels move rows with 16-byte loads and copies: each
    tensor's first element on a 16-byte boundary."""
    for k, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} does not start on a 16-byte boundary")


def _launch(lib_name: str, fn_name: str, device, *args) -> None:
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library(lib_name)
    with torch.cuda.device(device):
        status = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(status, fn_name)


def _ln_mlp_fwd_cuda(x, g, be, w1, b1, w2, b2, s, window_size, eps):
    name = "fused_ln_mlp"
    b, hh, ww, c = x.shape
    hidden, T = w1.shape[1], b * hh * ww
    if not ln_mlp_fits(hh, window_size, c):
        raise ValueError(
            f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} "
            "is outside the kernels' limits"
        )
    for k, t, shape in _mlp_operands(x, g, be, w1, b1, w2, b2, s):
        _check_cuda(k, t, shape, x.device)
    _check_aligned(name, x=x, g=g, be=be, w1=w1, b1=b1, w2=w2, b2=b2)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # scratch: LN2(x) and the hidden layer
    y = torch.empty((T, c), device=x.device, dtype=torch.float32)
    h = torch.empty((T, hidden), device=x.device, dtype=torch.float32)
    fused_ln_mlp.launches += 1
    _launch(
        "fused_block", "trr_ln_mlp_fwd", x.device,
        *(t.data_ptr() for t in (x, g, be, w1, b1, w2, b2, s, y, h, out)),
        b, hh, ww, c, hidden, eps,
    )
    return out


def _mlp_operands(x, g, be, w1, b1, w2, b2, s):
    b, hh, ww, c = x.shape
    hidden = w1.shape[1]
    return (
        ("x", x, (b, hh, ww, c)), ("g", g, (c,)), ("be", be, (c,)),
        ("w1", w1, (c, hidden)), ("b1", b1, (hidden,)), ("w2", w2, (hidden, c)),
        ("b2", b2, (c,)), ("s", s, (b,)),
    )


def fused_ln_mlp_bwd_reference(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps=1e-5):
    """The MLP backward kernel's spec, step by step, in fp32: dx and the
    gradients of g, be, w1, b1, w2, b2 (none for s, as in the JAX package),
    recomputing LN and fc1 from x."""
    b, hh, ww, c = x.shape
    t, do = x.float().reshape(-1, c), dout.float().reshape(-1, c)
    xn, inv = _ln_parts(t, eps)
    y = xn * g + be
    h = y @ w1 + b1
    dm = do * _row_scale(s, b, hh * ww)
    dw2, db2 = F.gelu(h, approximate="none").T @ dm, dm.sum(0)
    dh = (dm @ w2.T) * _gelu_grad(h)
    dw1, db1 = y.T @ dh, dh.sum(0)
    dy = dh @ w1.T
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dx = (do + _ln_backward(dy, xn, inv, g)).reshape(x.shape).to(x.dtype)
    return dx, dg, dbe, dw1, db1, dw2, db2


def fused_ln_mlp_backward(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps=1e-5):
    """The MLP backward (TPU kernel #7): dx, dg, dbe, dw1, db1, dw2, db2, as
    `fused_ln_mlp_bwd_reference` returns them. On a CUDA tensor it launches
    the kernels of `csrc/fused_block_train.cu` (one counted call: LN rows,
    the hidden-unit products, the LN backward's products, the weight
    gradients, on the tensor cores in 3xTF32); on a CPU tensor it runs the
    plain version. A bf16 x takes the bf16 form
    (`fused_ln_mlp_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        return fused_ln_mlp_backward_bf16(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps)
    if x.device.type == "cpu":
        return fused_ln_mlp_bwd_reference(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps)
    name = "fused_ln_mlp_backward"
    b, hh, ww, c = x.shape
    hidden, dev, T = w1.shape[1], x.device, b * hh * ww
    if not (ln_mlp_fits(hh, window_size, c) and ln_mlp_bwd_fits(c, hidden)):
        raise ValueError(f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} "
                         "is outside the kernels' limits")
    if T * hidden >= 2**31:
        raise ValueError(f"{name}: {T} tokens are more than the kernels index")
    for k, t, shape in _mlp_operands(x, g, be, w1, b1, w2, b2, s):
        _check_cuda(k, t, shape, dev)
    _check_cuda("dout", dout, tuple(x.shape), dev)

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    y, dm, stats, hg, dh = new(T, c), new(T, c), new(T, 2), new(T, hidden), new(T, hidden)
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c)
    part = new(max(_part_floats(T, hidden, c), _part_floats(T, c, hidden)))
    dx, dln = torch.empty_like(x), new(2 * c)
    d1, d2 = new(c * hidden + hidden), new(hidden * c + c)
    dyw = _split_rows_scratch(T, c, dev)
    fused_ln_mlp_backward.launches += 1
    fused_ln_mlp_backward.launches_c320 += c > ROWS_MAX_C
    _launch(
        "fused_block_train", "trr_ln_mlp_bwd", dev,
        *(t.data_ptr() for t in (x, dout, g, be, w1, b1, w2, s, y, stats, dm, hg, dh, ln_part,
                                 part)),
        None if dyw is None else dyw.data_ptr(), *(t.data_ptr() for t in (dx, dln, d1, d2)),
        b, hh, ww, c, hidden, eps,
    )
    return (dx, *dln.split(c), *_split_grad(d1, c, hidden), *_split_grad(d2, hidden, c))


fused_ln_mlp_backward.launches = 0
fused_ln_mlp_backward.launches_c320 = 0


def _split_rows_scratch(tokens: int, c: int, device) -> torch.Tensor | None:
    """The split rows stage's fp32 dy (tokens * c floats) where the rows are
    wider than ROWS_MAX_C, else None (a null pointer: the one-tile stage)."""
    if c <= ROWS_MAX_C:
        return None
    return torch.empty(tokens * c, device=device, dtype=torch.float32)


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, be, w1, b1, w2, b2, s, window_size, eps):
        args = (x, g, be, w1, b1, w2, b2, s, window_size, eps)
        if x.dtype == torch.bfloat16:
            out = fused_ln_mlp_bf16(*args)
        elif x.device.type == "cpu":
            out = fused_ln_mlp_reference(*args)
        else:
            out = _ln_mlp_fwd_cuda(*args)
        ctx.save_for_backward(x, g, be, w1, b1, w2, b2, s)
        ctx.meta = (window_size, eps)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g, be, w1, b1, w2, b2, s = ctx.saved_tensors
        grads = fused_ln_mlp_backward(x, g, be, w1, b1, w2, b2, s, dout.contiguous(), *ctx.meta)
        return (*grads, None, None, None)


def fused_ln_mlp(x, g, be, w1, b1, w2, b2, s, window_size, eps=1e-5):
    """out (B,H,W,C) = x + s[b] * fc2(gelu(fc1(LN(x)))), differentiable in
    x and the six parameters (not in s).

    g/be (C,) LayerNorm affine, w1 (C, hidden), b1 (hidden,), w2 (hidden, C),
    b2 (C,), s (B,) per-sample DropPath keep scale (ones at eval). On a CUDA
    tensor the forward launches TPU kernel #2's port and the backward #7's
    (`fused_ln_mlp_backward`); on a CPU tensor both run their plain versions.
    A bf16 x runs the bf16 forms (out and dx in bf16, the parameter
    gradients in fp32)."""
    return _LnMlp.apply(x, g, be, w1, b1, w2, b2, s, window_size, eps)


fused_ln_mlp.launches = 0


def _check_attn_operands(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                         window_size, shift, fits, kinds=None, xdtype=torch.float32):
    """Shapes, limits, types and placement of the attention half's operands
    (x of `xdtype`, the rest fp32); the saved-P backward passes no bias
    table but its `kinds`."""
    b, hh, ww, c = x.shape
    n = window_size * window_size
    kinds = bias.shape[0] if bias is not None else kinds
    if c != num_heads * head_dim or kinds not in (1, 4):
        raise ValueError(f"{name}: x {tuple(x.shape)}, {num_heads} heads of {head_dim}, "
                         f"{kinds} bias kinds do not match")
    if not 0 <= shift < min(hh, ww):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(hh, ww)})")
    if not fits(hh, ww, window_size, c, num_heads):
        raise ValueError(
            f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} "
            "is outside the kernels' limits"
        )
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    for k, t, shape in (
        ("x", x, (b, hh, ww, c)), ("g", g, (c,)), ("be", be, (c,)),
        ("wq", wq, (c, 3 * c)), ("bq", bq, (3 * c,)), ("wp", wp, (c, c)),
        ("bp", bp, (c,)), ("bias", bias, (kinds, num_heads, n, n)), ("s", s, (b,)),
    ):
        if t is not None:
            _check_cuda(k, t, shape, x.device, xdtype if k == "x" else torch.float32)


def _attn_block_fwd_cuda(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                         eps, shift):
    _check_attn_operands("fused_attn_block", x, g, be, wq, bq, wp, bp, bias, s, num_heads,
                         head_dim, window_size, shift, attn_block_fits)
    _check_aligned("fused_attn_block", x=x, g=g, be=be, wq=wq, bq=bq, wp=wp, bp=bp, bias=bias)
    b, hh, ww, c = x.shape
    z = torch.empty_like(x)
    if z.numel() == 0:
        return z
    T = b * hh * ww  # the stages pass LN1(x), qkv and att through (T, C), (T, 3C), (T, C)
    y, qkv, att = (torch.empty((T, k), device=x.device, dtype=torch.float32) for k in (c, 3 * c, c))
    fused_attn_block.launches += 1
    _launch(
        "fused_block", "trr_attn_block_fwd", x.device,
        *(t.data_ptr() for t in (x, g, be, wq, bq, wp, bp, bias, s, y, qkv, att, z)),
        b, hh, ww, c, num_heads, window_size, bias.shape[0], shift, eps, head_dim**-0.5,
    )
    return z


def fused_attn_block_bwd_reference(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads, head_dim,
                                   window_size, eps=1e-5, shift=0):
    """The recompute backward's spec, in fp32: dx and the gradients of g, be,
    wq, bq, wp, bp and the (K, nh, n, n) kind table (none for s, as in the
    JAX package). P and att are rebuilt from x, then the saved-P backward's
    spec (`fused_attn_block_train_bwd_reference`) takes them."""
    b, hh, ww, c = x.shape
    ws = window_size
    xn, _ = _ln_parts(_roll(x.float(), -shift).reshape(-1, c), eps)
    qkv = _to_windows(((xn * g + be) @ wq + bq).reshape(b, hh, ww, 3 * c), ws)
    q, k, v = (_heads(u, num_heads) for u in qkv.chunk(3, dim=-1))
    kind = window_kinds(hh // ws, ww // ws, bias.shape[0], device=x.device)
    table = bias.float()[kind].reshape(hh // ws, ww // ws, *bias.shape[1:])
    P = torch.softmax(q @ k.transpose(-1, -2) * head_dim**-0.5 + table, dim=-1)
    att = _roll(_from_windows(_merge_heads(P @ v), ws), shift)
    return fused_attn_block_train_bwd_reference(x, g, be, wq, bq, wp, bp, s, P, att, dout,
                                                bias.shape[0], num_heads, head_dim, ws, eps, shift)


def fused_attn_block_backward(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads, head_dim,
                              window_size, eps=1e-5, shift=0):
    """The attention half's recompute backward (TPU kernel #6): dx, dg, dbe,
    dwq, dbq, dwp, dbp, dbias, as `fused_attn_block_bwd_reference` returns
    them. On a CUDA tensor it launches the staged kernels of
    `csrc/attn_block_staged.cu` and the weight-gradient kernels of
    `csrc/fused_block_train.cu` (one counted call); on a CPU tensor it runs
    the plain version. A bf16 x takes the bf16 form
    (`fused_attn_block_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        return fused_attn_block_backward_bf16(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads,
                                              head_dim, window_size, eps, shift)
    if x.device.type == "cpu":
        return fused_attn_block_bwd_reference(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads,
                                              head_dim, window_size, eps, shift)
    name = "fused_attn_block_backward"
    _check_attn_operands(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                         window_size, shift, attn_block_bwd_fits)
    _check_cuda("dout", dout, tuple(x.shape), x.device)
    _check_aligned(name, x=x, dout=dout, g=g, be=be, wq=wq, bq=bq, wp=wp)
    b, hh, ww, c = x.shape
    ws, n, kinds, dev, T = window_size, window_size**2, bias.shape[0], x.device, b * hh * ww

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    qkv, dqkv = new(T, 3 * c), new(T, 3 * c)
    y, dzp, datt, att, stats = new(T, c), new(T, c), new(T, c), new(T, c), new(T, 2)
    ds = new(b, hh // ws, ww // ws, num_heads, n, n)
    dx, ln_part = torch.empty_like(x), new(math.ceil(T / TC_ROWS), 2 * c)
    dbias = new(kinds, num_heads, n, n)
    fused_attn_block_backward.launches += 1
    _launch(
        "attn_block_staged", "trr_attn_block_staged_bwd", dev,
        *(t.data_ptr() for t in (x, g, be, wq, bq, wp, bias, s, dout, qkv, y, stats, dzp, datt,
                                 dqkv, att, ds, dx, ln_part, dbias)),
        b, hh, ww, c, num_heads, ws, kinds, shift, eps, head_dim**-0.5,
    )
    dwq, dbq = _weight_grad(y, dqkv)
    dwp, dbp = _weight_grad(att, dzp)
    dg, dbe = _sum_rows(ln_part).split(c)
    return dx, dg, dbe, dwq, dbq, dwp, dbp, dbias


fused_attn_block_backward.launches = 0


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size, eps,
                shift):
        args = (x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size, eps, shift)
        if x.dtype == torch.bfloat16:
            z = fused_attn_block_bf16(*args)
        elif x.device.type == "cpu":
            z = fused_attn_block_reference(*args)
        else:
            z = _attn_block_fwd_cuda(*args)
        ctx.save_for_backward(x, g, be, wq, bq, wp, bp, bias, s)
        ctx.meta = (num_heads, head_dim, window_size, eps, shift)
        return z

    @staticmethod
    def backward(ctx, dz):
        grads = fused_attn_block_backward(*ctx.saved_tensors, dz.contiguous(), *ctx.meta)
        return (*grads, None, None, None, None, None, None)


def fused_attn_block(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                     eps=1e-5, shift=0):
    """z (B,H,W,C) = x + s[b] * proj(window-MHSA(qkv(LN(x)), bias)),
    differentiable in x, the six parameters and the kind table (not in s).

    wq (C, 3C), bq (3C,), wp (C, C), bp (C,), bias (K, nh, n, n) fp32 kind
    table (relative-position bias + shift mask, see
    window_attention.shift_mask_kinds), s (B,) DropPath keep scale. With
    shift=0, as in the JAX package, the caller passes x already rolled and
    unrolls z; with shift > 0 the kernel takes the windows of x rolled by
    (-shift, -shift) and returns z unrolled, in x's frame. On a CUDA tensor
    the forward launches TPU kernel #1's port (8x8 or 12x12 windows) and the
    backward #6's (`fused_attn_block_backward`); on a CPU tensor both run
    their plain versions. A bf16 x runs the bf16 forms at 12x12 windows (z
    and dx in bf16, the parameter gradients in fp32)."""
    return _AttnBlock.apply(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                            eps, shift)


fused_attn_block.launches = 0


# ---------------------------------------------------------------------------
# Training form of the attention half: the forward saving P and the attention
# output (TPU kernel #9) and the saved-P backward (TPU kernel #10), as one
# torch.autograd.Function.
# ---------------------------------------------------------------------------


def fused_attn_block_train_reference(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                                     window_size, eps=1e-5, shift=0):
    """The training forward's spec, in fp32: (z, P, att).

    z is `fused_attn_block_reference`'s; att (the attention output) is
    (B, H, W, C) in x's frame; P (B, H/ws, W/ws, nh, n, n) is the row softmax
    of every window and head of x rolled by (-shift, -shift), the JAX
    kernel's P of an input the caller has rolled."""
    b, hh, ww, c = x.shape
    ws = window_size
    xr = _roll(x.float(), -shift)
    y = F.layer_norm(xr, (c,), g.float(), be.float(), eps)
    qkv = _to_windows(y @ wq.float() + bq.float(), ws)
    q, k, v = (_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    kind = window_kinds(hh // ws, ww // ws, bias.shape[0], device=bias.device)
    table = bias.float()[kind].reshape(hh // ws, ww // ws, *bias.shape[1:])
    p = torch.softmax(q @ k.transpose(-1, -2) * head_dim**-0.5 + table, dim=-1)
    att = _from_windows(_merge_heads(p @ v), ws)
    z = xr + s.float()[:, None, None, None] * (att @ wp.float() + bp.float())
    return _roll(z, shift).to(x.dtype), p, _roll(att, shift)


def fused_attn_block_train_bwd_reference(x, g, be, wq, bq, wp, bp, s, P, att, dout, kinds,
                                         num_heads, head_dim, window_size, eps=1e-5, shift=0):
    """The saved-P backward's spec, step by step, in fp32: dx and the
    gradients of g, be, wq, bq, wp, bp and the (K, nh, n, n) kind table (none
    for s, as in the JAX package), from the forward's P and att. LN1 and qkv
    are rebuilt from x; no bias table is read."""
    b, hh, ww, c = x.shape
    ws = window_size

    def rows(t):
        return _roll(t.float(), -shift).reshape(b * hh * ww, -1)

    t, att, do = rows(x), rows(att), rows(dout)
    xn, inv = _ln_parts(t, eps)
    y = xn * g + be
    qkv = _to_windows((y @ wq + bq).reshape(b, hh, ww, 3 * c), ws)
    q, k, v = (_heads(u, num_heads) for u in qkv.chunk(3, dim=-1))
    dzp = do * _row_scale(s, b, hh * ww)
    dwp, dbp = att.T @ dzp, dzp.sum(0)
    dqkv, dbias = _window_attn_backward(P.float(), q, k, v, dzp @ wp.T, kinds, b, hh, ww,
                                        num_heads, head_dim, ws)
    dwq, dbq = y.T @ dqkv, dqkv.sum(0)
    dy = dqkv @ wq.T
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    dx = _roll((do + _ln_backward(dy, xn, inv, g)).reshape(b, hh, ww, c), shift)
    return dx.to(x.dtype), dg, dbe, dwq, dbq, dwp, dbp, dbias


def _attn_block_train_fwd_cuda(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                               window_size, eps, shift):
    b, hh, ww, c = x.shape
    _check_attn_operands("fused_attn_block_train", x, g, be, wq, bq, wp, bp, bias, s, num_heads,
                         head_dim, window_size, shift,
                         functools.partial(attn_block_train_fits, batch=b))
    _check_aligned("fused_attn_block_train", x=x, g=g, be=be, wq=wq, bq=bq, wp=wp, bp=bp,
                   bias=bias)
    ws, n = window_size, window_size**2
    z, att = torch.empty_like(x), torch.empty_like(x)
    P = torch.empty((b, hh // ws, ww // ws, num_heads, n, n), device=x.device,
                    dtype=torch.float32)
    if z.numel() == 0:
        return z, P, att
    T = b * hh * ww  # the stages pass LN1(x) and qkv through (T, C) and (T, 3C) scratch
    y, qkv = (torch.empty((T, k), device=x.device, dtype=torch.float32) for k in (c, 3 * c))
    fused_attn_block_train.launches += 1
    _launch(
        "attn_block_staged", "trr_attn_block_train_fwd", x.device,
        *(t.data_ptr() for t in (x, g, be, wq, bq, wp, bp, bias, s, y, qkv, P, att, z)),
        b, hh, ww, c, num_heads, ws, bias.shape[0], shift, eps, head_dim**-0.5,
    )
    return z, P, att


def fused_attn_block_train_backward(x, g, be, wq, bq, wp, bp, s, P, att, dout, kinds, num_heads,
                                    head_dim, window_size, eps=1e-5, shift=0):
    """The attention half's saved-P backward (TPU kernel #10): dx, dg, dbe,
    dwq, dbq, dwp, dbp, dbias, as `fused_attn_block_train_bwd_reference`
    returns them. On a CUDA tensor it launches the staged kernels of
    `csrc/attn_block_staged.cu` and the weight-gradient kernels of
    `csrc/fused_block_train.cu` (one counted call); on a CPU tensor it runs
    the plain version."""
    if x.device.type == "cpu":
        return fused_attn_block_train_bwd_reference(x, g, be, wq, bq, wp, bp, s, P, att, dout,
                                                    kinds, num_heads, head_dim, window_size, eps,
                                                    shift)
    name = "fused_attn_block_train_backward"
    b, hh, ww, c = x.shape
    ws, n, dev, T = window_size, window_size**2, x.device, b * hh * ww
    _check_attn_operands(name, x, g, be, wq, bq, wp, bp, None, s, num_heads, head_dim, ws, shift,
                         functools.partial(attn_block_train_fits, batch=b), kinds)
    _check_cuda("att", att, tuple(x.shape), dev)
    _check_cuda("dout", dout, tuple(x.shape), dev)
    _check_cuda("P", P, (b, hh // ws, ww // ws, num_heads, n, n), dev)
    _check_aligned(name, x=x, dout=dout, g=g, be=be, wq=wq, bq=bq, wp=wp, P=P)

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    qkv, dqkv = new(T, 3 * c), new(T, 3 * c)
    y, dzp, datt, stats = new(T, c), new(T, c), new(T, c), new(T, 2)
    ds, dx = torch.empty_like(P), torch.empty_like(x)
    ln_part, dbias = new(math.ceil(T / TC_ROWS), 2 * c), new(kinds, num_heads, n, n)
    fused_attn_block_train_backward.launches += 1
    _launch(
        "attn_block_staged", "trr_attn_block_train_bwd", dev,
        *(t.data_ptr() for t in (x, g, be, wq, bq, wp, s, P, dout, qkv, y, stats, dzp, datt, dqkv,
                                 ds, dx, ln_part, dbias)),
        b, hh, ww, c, num_heads, ws, kinds, shift, eps, head_dim**-0.5,
    )
    dwq, dbq = _weight_grad(y, dqkv)
    dwp, dbp = _weight_grad(att.view(T, c), dzp)
    dg, dbe = _sum_rows(ln_part).split(c)
    return dx, dg, dbe, dwq, dbq, dwp, dbp, dbias


fused_attn_block_train_backward.launches = 0


class _AttnBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size, eps,
                shift):
        args = (x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size, eps, shift)
        if x.device.type == "cpu":
            z, p, att = fused_attn_block_train_reference(*args)
        else:
            z, p, att = _attn_block_train_fwd_cuda(*args)
        ctx.save_for_backward(x, g, be, wq, bq, wp, bp, s, p, att)
        ctx.meta = (bias.shape[0], num_heads, head_dim, window_size, eps, shift)
        return z

    @staticmethod
    def backward(ctx, dz):
        grads = fused_attn_block_train_backward(*ctx.saved_tensors, dz.contiguous(), *ctx.meta)
        return (*grads, None, None, None, None, None, None)


def fused_attn_block_train(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                           eps=1e-5, shift=0):
    """`fused_attn_block`'s z, operands and shift contract, for training: the
    forward saves the softmax P of every window and head and the attention
    output, and the backward computes every gradient from them instead of
    recomputing the softmax (4 attention products per window and head, not
    6; no bias table read). Differentiable in x, the six parameters and the
    kind table (not in s). P costs B * H * W * heads * n floats of memory
    until the backward. On a CUDA tensor the forward launches TPU kernel
    #9's port and the backward #10's (`fused_attn_block_train_backward`),
    8x8 or 12x12 windows; on a CPU tensor both run their plain versions."""
    return _AttnBlockTrain.apply(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                                 window_size, eps, shift)


fused_attn_block_train.launches = 0


# ---------------------------------------------------------------------------
# Training: the whole block, forward (TPU kernel #4) and saved-P backward
# (TPU kernel #5), as one torch.autograd.Function.
# ---------------------------------------------------------------------------


def swin_block_train_fits(h, w, window_size, channels, num_heads, hidden) -> bool:
    """The training kernels' limits, in fp32 and in bf16: 8x8 windows, rows
    of at most SWIN_BLOCK_MAX_C channels (SwinIR-L's 240 keeps the unfused
    branch), the forward halves' plans, the MLP half's backward
    (`ln_mlp_bwd_fits`) and the saved-P attention stage's plans (#10's at 8x8)
    within one thread block's."""
    if window_size != WINDOW or channels > SWIN_BLOCK_MAX_C:
        return False
    if not (attn_block_fits(h, w, window_size, channels, num_heads)
            and ln_mlp_fits(h, window_size, channels)):
        return False
    return (ln_mlp_bwd_fits(channels, hidden)
            and attn_train_bwd_smem_bytes(channels, num_heads, window_size) <= SMEM_LIMIT)


def _roll(t, shift):
    return torch.roll(t, (shift, shift), dims=(1, 2)) if shift else t


def _to_windows(t, ws):
    """(B, H, W, X) -> (B, H/ws, W/ws, ws*ws, X), tokens row-major in a window."""
    b, hh, ww, x = t.shape
    t = t.reshape(b, hh // ws, ws, ww // ws, ws, x).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, hh // ws, ww // ws, ws * ws, x)


def _from_windows(t, ws):
    b, nwh, nww, _, x = t.shape
    t = t.reshape(b, nwh, nww, ws, ws, x).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, nwh * ws, nww * ws, x)


def _heads(t, num_heads):
    """(..., n, nh*hd) -> (..., nh, n, hd)."""
    return t.unflatten(-1, (num_heads, -1)).transpose(-3, -2)


def _merge_heads(t):
    return t.transpose(-3, -2).flatten(-2)


def _ln_parts(t, eps):
    """(xn, 1/std) of a LayerNorm over the last axis (two-pass, as the kernels)."""
    xc = t - t.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * inv, inv


def _ln_backward(dy, xn, inv, g):
    dxh = dy * g
    return inv * (dxh - dxh.mean(-1, keepdim=True) - xn * (dxh * xn).mean(-1, keepdim=True))


def _gelu_grad(h):
    cdf = 0.5 * (1.0 + torch.erf(h * 2.0**-0.5))
    return cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def _window_attn_backward(P, q, k, v, datt, kinds, b, hh, ww, num_heads, head_dim, ws,
                          rounded=False):
    """(dqkv (T, 3C), dbias (K, nh, n, n)) of softmax(q k^T scale + bias) v
    from its softmax P and q, k, v, all (B, H/ws, W/ws, nh, n, .), and the
    output gradient datt (T, C); dbias sums dS over each kind's windows.
    `rounded`, the bf16 kernel's arithmetic: dv from bf16(P) (P itself where
    the forward saved it in bf16), dS from P, dq and dk from bf16(scale dS),
    and dq, dk, dv rounded to bf16 (dbias from the fp32 dS)."""
    nwh, nww, n = hh // ws, ww // ws, ws * ws
    da = _heads(_to_windows(datt.reshape(b, hh, ww, -1), ws), num_heads)
    dv = (_bf(P) if rounded else P).transpose(-1, -2) @ da
    dp = da @ v.transpose(-1, -2)
    ds = P * (dp - (dp * P).sum(-1, keepdim=True))
    scale = head_dim**-0.5
    if rounded:
        ds_lo = _bf(ds * scale)
        dq, dk, dv = _bf(ds_lo @ k), _bf(ds_lo.transpose(-1, -2) @ q), _bf(dv)
    else:
        dq, dk = ds @ k * scale, ds.transpose(-1, -2) @ q * scale
    dbias = torch.zeros(kinds, num_heads, n, n, dtype=torch.float32, device=P.device)
    dbias.index_add_(0, window_kinds(nwh, nww, kinds, device=P.device),
                     ds.sum(0).reshape(nwh * nww, num_heads, n, n))
    dqkv = torch.cat([_merge_heads(u) for u in (dq, dk, dv)], dim=-1)
    return _from_windows(dqkv, ws).reshape(b * hh * ww, -1), dbias


def fused_swin_block_train_reference(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2,
                                     s1, s2, num_heads, head_dim, window_size, eps=1e-5,
                                     shift=0):
    """The train forward's spec, in fp32: (out, P, att, z), the attention
    half's training form followed by the MLP half.

    x, out, att (the attention output) and z (the mid-block residual) are
    (B, H, W, C) in x's frame; P (B, H/ws, W/ws, nh, n, n) is the row softmax
    of every window and head of x rolled by (-shift, -shift)."""
    z, p, att = fused_attn_block_train_reference(x, g1, be1, wq, bq, wp, bp, bias, s1, num_heads,
                                                 head_dim, window_size, eps, shift)
    # the MLP half is per-token; it runs on the rolled rows, as the kernels sum them
    out = fused_ln_mlp_reference(_roll(z, -shift), g2, be2, w1, b1, w2, b2, s2, window_size, eps)
    return _roll(out, shift), p, att, z


def fused_swin_block_train_bwd_reference(x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2,
                                         s1, s2, P, att, z, dout, kinds, num_heads, head_dim,
                                         window_size, eps=1e-5, shift=0):
    """The saved-P backward's spec, in fp32: returns dx and the gradients of
    g1, be1, wq, bq, wp, bp, the (K, nh, n, n) kind table, g2, be2, w1, b1,
    w2, b2, from the forward's saved P, att and z: the MLP half's backward
    (LN2 and fc1 recomputed from z) gives dz, the attention half's saved-P
    backward the rest."""
    dz, dg2, dbe2, dw1, db1, dw2, db2 = fused_ln_mlp_bwd_reference(
        _roll(z, -shift), g2, be2, w1, b1, w2, b2, s2, _roll(dout, -shift), window_size, eps)
    attn = fused_attn_block_train_bwd_reference(x, g1, be1, wq, bq, wp, bp, s1, P, att,
                                                _roll(dz, shift), kinds, num_heads, head_dim,
                                                window_size, eps, shift)
    return (*attn, dg2, dbe2, dw1, db1, dw2, db2)


# ---------------------------------------------------------------------------
# The whole block's bf16 forms: the JAX kernel computes in x.dtype, so a
# bf16 training step runs #4 and #5 on bf16 activations (weights cast to
# bf16 as they go in; LayerNorm parameters, biases, the bias table and the
# DropPath scales fp32), every product summed in fp32 and rounded to bf16
# where the JAX kernel rounds (ops/pallas/fused_block.py:1092-1290), the
# statistics, softmax and gelu in fp32, and the gradients of the parameters
# in fp32.
# ---------------------------------------------------------------------------


def _ln_mlp_bf16_rows(t, g, be, w1, b1, w2, b2, srow, eps):
    """The MLP half in bf16 on rows t (T, C) held in fp32 (bf16 values),
    with the JAX kernel's roundings (ops/pallas/fused_block.py:196-208): y =
    bf16(LN(t)) from fp32 statistics, h = bf16(y w1) + bf16(b1), hg =
    bf16(gelu(h)), m = bf16(hg w2) + bf16(b2), out = t + bf16(s) m, every
    addition and product a bf16 operation (rounded); srow (T, 1) the fp32
    DropPath scale of each row."""
    xn, _ = _ln_parts(t, eps)
    y = _bf(xn * g.float() + be.float())
    hg = _bf(F.gelu(_bf(_bf(y @ _bf(w1)) + _bf(b1.float())), approximate="none"))
    return _bf(t + _bf(_bf(srow) * _bf(_bf(hg @ _bf(w2)) + _bf(b2.float()))))


def _ln_mlp_bwd_bf16_rows(t, do, g, be, w1, b1, w2, srow, eps):
    """The MLP half's backward in bf16 on rows t and do (T, C) in fp32
    (bf16 values), with the JAX kernel's roundings
    (ops/pallas/fused_block.py:210-254): (dt, dg, dbe, dw1, db1, dw2, db2),
    dt = do + LN'(dy) in fp32 (the caller rounds it or not). LN and h are
    recomputed as the forward rounds them; dm = do s and dh are rounded to
    bf16 as operands, while db2 and db1 sum the fp32 dm and dh; every
    LayerNorm gradient is fp32."""
    g, be, b1 = g.float(), be.float(), b1.float()
    xn, inv = _ln_parts(t, eps)
    y = _bf(xn * g + be)
    h = _bf(_bf(y @ _bf(w1)) + _bf(b1))
    hg = _bf(F.gelu(h, approximate="none"))
    dm = do * srow
    dm_lo = _bf(dm)
    dw2, db2 = hg.T @ dm_lo, dm.sum(0)
    dh = (dm_lo @ _bf(w2).T) * _gelu_grad(h)
    dh_lo = _bf(dh)
    dw1, db1 = y.T @ dh_lo, dh.sum(0)
    dy = dh_lo @ _bf(w1).T
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    return do + _ln_backward(dy, xn, inv, g), dg, dbe, dw1, db1, dw2, db2


def fused_ln_mlp_bf16_reference(x, g, be, w1, b1, w2, b2, s, window_size, eps=1e-5):
    """#2's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (`_ln_mlp_bf16_rows`): out (B, H, W, C) bf16 from a bf16 x and the fp32
    parameters."""
    b, hh, ww, c = x.shape
    out = _ln_mlp_bf16_rows(x.float().reshape(-1, c), g, be, w1, b1, w2, b2,
                            _row_scale(s, b, hh * ww), eps)
    return out.reshape(x.shape).to(torch.bfloat16)


def fused_ln_mlp_bwd_bf16_reference(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps=1e-5):
    """#7's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (`_ln_mlp_bwd_bf16_rows`): dx = bf16(dout + LN'(dy)) and the fp32
    gradients of g, be, w1, b1, w2, b2, as `fused_ln_mlp_bwd_reference`
    orders them."""
    b, hh, ww, c = x.shape
    dt, *grads = _ln_mlp_bwd_bf16_rows(x.float().reshape(-1, c), dout.float().reshape(-1, c), g,
                                       be, w1, b1, w2, _row_scale(s, b, hh * ww), eps)
    return (dt.reshape(x.shape).to(torch.bfloat16), *grads)


def _check_ln_mlp_bf16(name, x, g, be, w1, b1, w2, b2, s, window_size, dout=None):
    """Limits, shapes, types and placement of the bf16 MLP half's operands
    (x and dout bf16, the parameters and s fp32); returns w1 and w2 cast to
    bf16. The bf16 forms take the rows the fp32 backward takes
    (`ln_mlp_bwd_fits`: rows of at most MLP_ROWS_MAX_C channels, on one rows
    tile up to ROWS_MAX_C and on the split rows stage past it, C and hidden
    multiples of 4; their plans fit at every such width)."""
    b, hh, ww, c = x.shape
    hidden = w1.shape[1]
    if not (ln_mlp_fits(hh, window_size, c) and ln_mlp_bwd_fits(c, hidden)):
        raise ValueError(
            f"{name}: H={hh}, C={c}, hidden={hidden}, ws={window_size} is outside the bf16 "
            f"kernels' limits (C <= {MLP_ROWS_MAX_C}, C and hidden multiples of 4)")
    if b * hh * ww * hidden >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    for k, t, shape in _mlp_operands(x, g, be, w1, b1, w2, b2, s):
        _check_cuda(k, t, shape, x.device, torch.bfloat16 if k == "x" else torch.float32)
    if dout is not None:
        _check_cuda("dout", dout, tuple(x.shape), x.device, torch.bfloat16)
    w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    _check_aligned(name, x=x, g=g, be=be, w1=w1, b1=b1, w2=w2, b2=b2,
                   **({} if dout is None else {"dout": dout}))
    return w1, w2


def fused_ln_mlp_bf16(x, g, be, w1, b1, w2, b2, s, window_size, eps=1e-5):
    """#2's bf16 form: out (B, H, W, C) bf16 of a bf16 x from the fp32
    parameters, as `fused_ln_mlp_bf16_reference` computes it. On a CUDA
    tensor it casts w1 and w2 to bf16 and launches `trr_ln_mlp_fwd_bf16`
    (one counted call, three launches: #4's MLP stages); on a CPU tensor it
    runs the plain version. Outside the fp32 backward's limits it raises."""
    if x.device.type == "cpu":
        return fused_ln_mlp_bf16_reference(x, g, be, w1, b1, w2, b2, s, window_size, eps)
    name = "fused_ln_mlp_bf16"
    w1, w2 = _check_ln_mlp_bf16(name, x, g, be, w1, b1, w2, b2, s, window_size)
    b, hh, ww, c = x.shape
    hidden, T = w1.shape[1], b * hh * ww
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    y = torch.empty((T, c), device=x.device, dtype=torch.bfloat16)
    h = torch.empty((T, hidden), device=x.device, dtype=torch.bfloat16)
    fused_ln_mlp_bf16.launches += 1
    _launch(
        "fused_block_train", "trr_ln_mlp_fwd_bf16", x.device,
        *(t.data_ptr() for t in (x, g, be, w1, b1, w2, b2, s, y, h, out)),
        b, hh, ww, c, hidden, eps,
    )
    return out


def fused_ln_mlp_backward_bf16(x, g, be, w1, b1, w2, b2, s, dout, window_size, eps=1e-5):
    """#7's bf16 form: dx (bf16) and the fp32 gradients of g, be, w1, b1,
    w2, b2 from the bf16 x and dout, as `fused_ln_mlp_bwd_bf16_reference`
    computes them. On a CUDA tensor it launches `trr_ln_mlp_bwd_bf16` (one
    counted call: #5's MLP stages and its two weight gradients); on a CPU
    tensor it runs the plain version."""
    if x.device.type == "cpu":
        return fused_ln_mlp_bwd_bf16_reference(x, g, be, w1, b1, w2, b2, s, dout, window_size,
                                               eps)
    name = "fused_ln_mlp_backward_bf16"
    w1h, w2h = _check_ln_mlp_bf16(name, x, g, be, w1, b1, w2, b2, s, window_size, dout)
    b, hh, ww, c = x.shape
    hidden, dev, T = w1.shape[1], x.device, b * hh * ww

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    y, dm = new(T, c, dtype=torch.bfloat16), new(T, c, dtype=torch.bfloat16)
    hg, dh = new(T, hidden, dtype=torch.bfloat16), new(T, hidden, dtype=torch.bfloat16)
    stats, dh32 = new(T, 2), new(T, hidden)
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c)
    part = new(max(_part_floats_bf16(T, hidden, c), _part_floats_bf16(T, c, hidden)))
    dx, dln = torch.empty_like(x), new(2 * c)
    d1, d2 = new(c * hidden + hidden), new(hidden * c + c)
    dyw = _split_rows_scratch(T, c, dev)
    fused_ln_mlp_backward_bf16.launches += 1
    fused_ln_mlp_backward_bf16.launches_c320 += c > ROWS_MAX_C
    _launch(
        "fused_block_train", "trr_ln_mlp_bwd_bf16", dev,
        *(t.data_ptr() for t in (x, dout, g, be, w1h, b1, w2h, s, y, stats, dm, hg, dh, dh32,
                                 ln_part, part)),
        None if dyw is None else dyw.data_ptr(), *(t.data_ptr() for t in (dx, dln, d1, d2)),
        b, hh, ww, c, hidden, eps,
    )
    return (dx, *dln.split(c), *_split_grad(d1, c, hidden), *_split_grad(d2, hidden, c))


fused_ln_mlp_bf16.launches = 0
fused_ln_mlp_backward_bf16.launches = 0
fused_ln_mlp_backward_bf16.launches_c320 = 0


def _qkv_bf16_rows(t, g, be, wq, bq, b, hh, ww, num_heads, ws, eps):
    """(y, (q, k, v)) of rows t (T, C) of the rolled frame in bf16, with the
    JAX kernel's roundings: y = bf16(LN(t)) from fp32 statistics and the
    heads of qkv = bf16(bf16(y wq) + bf16(bq)), (B, H/ws, W/ws, nh, n, hd)."""
    c = t.shape[1]
    xn, _ = _ln_parts(t, eps)
    y = _bf(xn * g.float() + be.float())
    qkv = _bf(_bf(y @ _bf(wq)) + _bf(bq.float()))
    heads = (_heads(u, num_heads)
             for u in _to_windows(qkv.reshape(b, hh, ww, 3 * c), ws).chunk(3, dim=-1))
    return y, tuple(heads)


def _attn_half_bf16_rows(t, g, be, wq, bq, wp, bp, bias, srow, b, hh, ww, num_heads, head_dim,
                         ws, eps):
    """The attention half in bf16 on rows t (T, C) of the rolled frame held
    in fp32 (bf16 values), with the JAX kernel's roundings
    (ops/pallas/fused_block.py:468-511): P the fp32 softmax of q k^T scale +
    bias, att = bf16(bf16(P) v), z = t + bf16(s) (bf16(att wp) + bf16(bp)),
    each bf16 addition and product rounded; srow (T, 1) the fp32 DropPath
    scale of each row. Returns (z, P, att, y, (q, k, v)), P unrounded."""
    c = t.shape[1]
    y, (q, k, v) = _qkv_bf16_rows(t, g, be, wq, bq, b, hh, ww, num_heads, ws, eps)
    kind = window_kinds(hh // ws, ww // ws, bias.shape[0], device=t.device)
    table = bias.float()[kind].reshape(hh // ws, ww // ws, *bias.shape[1:])
    p = torch.softmax(q @ k.transpose(-1, -2) * head_dim**-0.5 + table, dim=-1)
    att = _bf(_from_windows(_merge_heads(_bf(p) @ v), ws).reshape(-1, c))
    z = _bf(t + _bf(_bf(srow) * _bf(_bf(att @ _bf(wp)) + _bf(bp.float()))))
    return z, p, att, y, (q, k, v)


def _attn_half_bwd_bf16_rows(t, dz, P, att, y, heads, g, wq, wp, srow, kinds, b, hh, ww,
                             num_heads, head_dim, ws, eps):
    """The attention half's backward in bf16 on rows t and dz (T, C) of the
    rolled frame, with the JAX kernel's roundings
    (ops/pallas/fused_block.py:513-634): from P, att and the forward's y and
    heads, (dt, dg, dbe, dwq, dbq, dwp, dbp, dbias) with dt = dz + LN'(dy)
    in fp32 (the caller rounds it). dzp = dz s and datt are rounded to bf16
    as operands while dbp sums the fp32 dzp; the window attention's as
    `_window_attn_backward(rounded=True)`; dy = dqkv wq^T, every LayerNorm
    gradient and dbias stay fp32."""
    xn, inv = _ln_parts(t, eps)
    dzp = dz * srow
    dzp_lo = _bf(dzp)
    dwp, dbp = att.T @ dzp_lo, dzp.sum(0)
    datt = _bf(dzp_lo @ _bf(wp).T)
    dqkv, dbias = _window_attn_backward(P, *heads, datt, kinds, b, hh, ww, num_heads, head_dim,
                                        ws, rounded=True)
    dwq, dbq = y.T @ dqkv, dqkv.sum(0)
    dy = dqkv @ _bf(wq).T
    dg, dbe = (dy * xn).sum(0), dy.sum(0)
    return dz + _ln_backward(dy, xn, inv, g.float()), dg, dbe, dwq, dbq, dwp, dbp, dbias


def fused_swin_block_train_bf16_reference(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2,
                                          b2, s1, s2, num_heads, head_dim, window_size, eps=1e-5,
                                          shift=0):
    """#4's bf16 form, step by step in fp32 with the JAX kernel's roundings:
    (out, P, att, z) in bf16, laid out as `fused_swin_block_train_reference`
    returns them. qkv, P, the head outputs, proj, z, h1, gelu(h1), m2 and out
    are rounded to bf16; each bf16 bias and DropPath scale is added or
    applied as a bf16 operation (rounded); the products sum exactly the
    bf16 values in fp32."""
    b, hh, ww, c = x.shape
    t = _roll(x.float(), -shift).reshape(-1, c)
    z, p, att, _, _ = _attn_half_bf16_rows(t, g1, be1, wq, bq, wp, bp, bias,
                                           _row_scale(s1, b, hh * ww), b, hh, ww, num_heads,
                                           head_dim, window_size, eps)
    out = _ln_mlp_bf16_rows(z, g2, be2, w1, b1, w2, b2, _row_scale(s2, b, hh * ww), eps)

    def unroll(u):
        return _roll(u.reshape(b, hh, ww, c), shift).to(torch.bfloat16)

    return unroll(out), p.to(torch.bfloat16), unroll(att), unroll(z)


def fused_swin_block_train_bwd_bf16_reference(x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2,
                                              b2, s1, s2, P, att, z, dout, kinds, num_heads,
                                              head_dim, window_size, eps=1e-5, shift=0):
    """#5's bf16 form, step by step in fp32 with the JAX kernel's roundings:
    dx (bf16) and the 13 parameter gradients (fp32), in
    `fused_swin_block_train_bwd_reference`'s order, from the bf16 P, att and
    z. The MLP half recomputes LN2, h1 and gelu(h1) as the forward rounds
    them; dm, dh, dzp, datt, dS (scaled) and dq, dk, dv are rounded to bf16
    as operands, while db2, db1 and dbp sum the fp32 dm, dh and dzp, and dz,
    every LayerNorm gradient and dbias stay fp32."""
    b, hh, ww, c = x.shape
    ws, tokens = window_size, b * hh * ww

    def rows(u):
        return _roll(u.float(), -shift).reshape(tokens, -1)

    t, zt, do, att_t = rows(x), rows(z), rows(dout), rows(att)
    # the MLP half: dz in fp32
    dz, dg2, dbe2, dw1, db1, dw2, db2 = _ln_mlp_bwd_bf16_rows(
        zt, do, g2, be2, w1, b1, w2, _row_scale(s2, b, hh * ww), eps)
    # the attention half, from the saved P and att
    y, heads = _qkv_bf16_rows(t, g1, be1, wq, bq, b, hh, ww, num_heads, ws, eps)
    dt, *attn = _attn_half_bwd_bf16_rows(t, dz, P.float(), att_t, y, heads, g1, wq, wp,
                                         _row_scale(s1, b, hh * ww), kinds, b, hh, ww, num_heads,
                                         head_dim, ws, eps)
    dx = _roll(dt.reshape(b, hh, ww, c), shift)
    return (dx.to(torch.bfloat16), *attn, dg2, dbe2, dw1, db1, dw2, db2)


def fused_attn_block_bf16_reference(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                                    window_size, eps=1e-5, shift=0):
    """#1's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (`_attn_half_bf16_rows`): z (B, H, W, C) bf16 from a bf16 x and the fp32
    parameters, in x's frame."""
    b, hh, ww, c = x.shape
    t = _roll(x.float(), -shift).reshape(-1, c)
    z, *_ = _attn_half_bf16_rows(t, g, be, wq, bq, wp, bp, bias, _row_scale(s, b, hh * ww), b,
                                 hh, ww, num_heads, head_dim, window_size, eps)
    return _roll(z.reshape(b, hh, ww, c), shift).to(torch.bfloat16)


def fused_attn_block_bwd_bf16_reference(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads,
                                        head_dim, window_size, eps=1e-5, shift=0):
    """#6's bf16 form, step by step in fp32 with the JAX kernel's roundings:
    dx = bf16(dout + LN'(dy)) and the fp32 gradients of g, be, wq, bq, wp,
    bp and the kind table, as `fused_attn_block_bwd_reference` orders them.
    P and att are recomputed as the forward computes them (P in fp32: dv
    takes bf16(P), dS the fp32 P), dz = dout s in fp32."""
    b, hh, ww, c = x.shape
    ws, tokens, srow = window_size, b * hh * ww, _row_scale(s, b, hh * ww)

    def rows(u):
        return _roll(u.float(), -shift).reshape(tokens, -1)

    t, do = rows(x), rows(dout)
    _, p, att, y, heads = _attn_half_bf16_rows(t, g, be, wq, bq, wp, bp, bias, srow, b, hh, ww,
                                               num_heads, head_dim, ws, eps)
    dt, *grads = _attn_half_bwd_bf16_rows(t, do, p, att, y, heads, g, wq, wp, srow,
                                          bias.shape[0], b, hh, ww, num_heads, head_dim, ws, eps)
    dx = _roll(dt.reshape(b, hh, ww, c), shift)
    return (dx.to(torch.bfloat16), *grads)


def _group_part_floats(b: int, hh: int, ww: int, num_heads: int, kinds: int) -> int:
    """Floats of the groups' dbias sums of #6's bf16 window attention."""
    from trainner_redux_tpu_torch.ops import cuda_build

    return cuda_build.library("fused_block_train").trr_attn_group_part_floats(
        b, hh, ww, num_heads, kinds)


def _check_attn_bf16(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                     shift, dout=None):
    """Limits, shapes, types and placement of the bf16 attention half's
    operands (x and dout bf16, the parameters, kind table and s fp32);
    returns wq and wp cast to bf16. Outside `attn_block_bf16_fits` it
    raises, naming the limits."""
    b, hh, ww, c = x.shape
    if not attn_block_bf16_fits(hh, ww, window_size, c, num_heads):
        raise ValueError(
            f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, ws={window_size} is outside "
            f"the bf16 kernels' limits (12x12 windows, heads of at most {V_LD} channels, C <= "
            f"{ROWS_MAX_C} and a multiple of 4)")
    _check_attn_operands(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                         window_size, shift, attn_block_bf16_fits, xdtype=torch.bfloat16)
    if dout is not None:
        _check_cuda("dout", dout, tuple(x.shape), x.device, torch.bfloat16)
    wq, wp = wq.to(torch.bfloat16), wp.to(torch.bfloat16)
    _check_aligned(name, x=x, g=g, be=be, wq=wq, bq=bq, wp=wp, bp=bp, bias=bias,
                   **({} if dout is None else {"dout": dout}))
    return wq, wp


def fused_attn_block_bf16(x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim, window_size,
                          eps=1e-5, shift=0):
    """#1's bf16 form at 12x12 windows: z (B, H, W, C) bf16 of a bf16 x from
    the fp32 parameters, as `fused_attn_block_bf16_reference` computes it.
    On a CUDA tensor it casts wq and wp to bf16 (and hands their
    transposes, the K-major operands of the TMA-fed products) and launches
    `trr_attn_block_fwd_bf16` (one counted call, four launches: the LN
    rows, qkv, the window attention over groups of one kind's windows,
    proj with the residual); on a CPU tensor it runs the plain version.
    Outside `attn_block_bf16_fits` a CUDA tensor raises."""
    if x.device.type == "cpu":
        return fused_attn_block_bf16_reference(x, g, be, wq, bq, wp, bp, bias, s, num_heads,
                                               head_dim, window_size, eps, shift)
    name = "fused_attn_block_bf16"
    wq, wp = _check_attn_bf16(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                              window_size, shift)
    b, hh, ww, c = x.shape
    z = torch.empty_like(x)
    if z.numel() == 0:
        return z
    T = b * hh * ww  # the stages pass LN1(x), qkv and att through (T, C), (T, 3C), (T, C)
    y, qkv, att = (torch.empty((T, k), device=x.device, dtype=torch.bfloat16)
                   for k in (c, 3 * c, c))
    # the products' K-major weights (W^T) for the TMA-fed stage
    wqt, wpt = wq.t().contiguous(), wp.t().contiguous()
    fused_attn_block_bf16.launches += 1
    _launch(
        "fused_block_train", "trr_attn_block_fwd_bf16", x.device,
        *(t.data_ptr() for t in (x, g, be, wq, wqt, bq, wp, wpt, bp, bias, s, y, qkv, att, z)),
        b, hh, ww, c, num_heads, window_size, bias.shape[0], shift, eps, head_dim**-0.5,
    )
    return z


def fused_attn_block_backward_bf16(x, g, be, wq, bq, wp, bp, bias, s, dout, num_heads, head_dim,
                                   window_size, eps=1e-5, shift=0):
    """#6's bf16 form at 12x12 windows: dx (bf16) and the fp32 gradients of
    g, be, wq, bq, wp, bp and the kind table from the bf16 x and dout, as
    `fused_attn_block_bwd_bf16_reference` computes them. On a CUDA tensor it
    launches `trr_attn_block_bwd_bf16` (one counted call: the per-token
    stages, the recompute window attention over groups of windows of one
    kind, writing att and summing dbias in the kernel, two weight
    gradients); on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return fused_attn_block_bwd_bf16_reference(x, g, be, wq, bq, wp, bp, bias, s, dout,
                                                   num_heads, head_dim, window_size, eps, shift)
    name = "fused_attn_block_backward_bf16"
    wqh, wph = _check_attn_bf16(name, x, g, be, wq, bq, wp, bp, bias, s, num_heads, head_dim,
                                window_size, shift, dout)
    b, hh, ww, c = x.shape
    ws, n, kinds, dev, T = window_size, window_size**2, bias.shape[0], x.device, b * hh * ww

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    y, dzp, datt, att = (new(T, c, dtype=torch.bfloat16) for _ in range(4))
    qkv, dqkv = new(T, 3 * c, dtype=torch.bfloat16), new(T, 3 * c, dtype=torch.bfloat16)
    stats, ds = new(T, 2), new(_group_part_floats(b, hh, ww, num_heads, kinds))
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c)
    part = new(max(_part_floats_bf16(T, c, c), _part_floats_bf16(T, c, 3 * c)))
    dx, dln, dbias = torch.empty_like(x), new(2 * c), new(kinds, num_heads, n, n)
    dq, dp = new(c * 3 * c + 3 * c), new(c * c + c)
    fused_attn_block_backward_bf16.launches += 1
    _launch(
        "fused_block_train", "trr_attn_block_bwd_bf16", dev,
        *(t.data_ptr() for t in (x, g, be, wqh, bq, wph, bias, s, dout, y, stats, dzp, datt, qkv,
                                 dqkv, att, ds, ln_part, part, dx, dln, dq, dp, dbias)),
        b, hh, ww, c, num_heads, ws, kinds, shift, eps, head_dim**-0.5,
    )
    return (dx, *dln.split(c), *_split_grad(dq, c, 3 * c), *_split_grad(dp, c, c), dbias)


fused_attn_block_bf16.launches = 0
fused_attn_block_backward_bf16.launches = 0


def _check_train_shapes(x, w1, kinds, num_heads, head_dim, window_size, shift, name):
    b, hh, ww, c = x.shape
    hidden = w1.shape[1]
    if c != num_heads * head_dim or kinds not in (1, 4):
        raise ValueError(f"{name}: x {tuple(x.shape)}, {num_heads} heads of {head_dim}, "
                         f"{kinds} bias kinds do not match")
    if not 0 <= shift < min(hh, ww):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(hh, ww)})")
    if not swin_block_train_fits(hh, ww, window_size, c, num_heads, hidden):
        raise ValueError(
            f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, hidden={hidden}, "
            f"ws={window_size} is outside the kernels' limits (SwinBlock takes its "
            "unfused branch for such a block)"
        )
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")


def _param_shapes(c, hidden, kinds, num_heads, n):
    return {
        "g1": (c,), "be1": (c,), "wq": (c, 3 * c), "bq": (3 * c,), "wp": (c, c), "bp": (c,),
        "bias": (kinds, num_heads, n, n), "g2": (c,), "be2": (c,), "w1": (c, hidden),
        "b1": (hidden,), "w2": (hidden, c), "b2": (c,),
    }


def _swin_block_train_fwd_cuda(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1,
                               s2, num_heads, head_dim, window_size, eps, shift):
    if x.dtype == torch.bfloat16:
        return fused_swin_block_train_bf16(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2,
                                           b2, s1, s2, num_heads, head_dim, window_size, eps,
                                           shift)
    name = "fused_swin_block_train"
    _check_train_shapes(x, w1, bias.shape[0], num_heads, head_dim, window_size, shift, name)
    b, hh, ww, c = x.shape
    hidden, kinds, n = w1.shape[1], bias.shape[0], window_size**2
    shapes = _param_shapes(c, hidden, kinds, num_heads, n)
    ops = dict(g1=g1, be1=be1, wq=wq, bq=bq, wp=wp, bp=bp, bias=bias, g2=g2, be2=be2, w1=w1,
               b1=b1, w2=w2, b2=b2)
    _check_cuda("x", x, (b, hh, ww, c), x.device)
    for k, t in ops.items():
        _check_cuda(k, t, shapes[k], x.device)
    _check_cuda("s1", s1, (b,), x.device)
    _check_cuda("s2", s2, (b,), x.device)
    _check_aligned(name, x=x, **ops)
    out, att, z = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    p = torch.empty((b, hh // window_size, ww // window_size, num_heads, n, n),
                    device=x.device, dtype=torch.float32)
    if x.numel() == 0:
        return out, p, att, z
    T = b * hh * ww  # scratch: LN1(x), then LN2(z); qkv; the MLP's hidden layer
    y, qkv, h = (torch.empty((T, k), device=x.device, dtype=torch.float32)
                 for k in (c, 3 * c, hidden))
    fused_swin_block_train.launches += 1
    _launch(
        "fused_block_train", "trr_swin_block_fwd", x.device,
        x.data_ptr(), *(t.data_ptr() for t in ops.values()), s1.data_ptr(), s2.data_ptr(),
        *(t.data_ptr() for t in (y, qkv, h, out, p, att, z)),
        b, hh, ww, c, num_heads, hidden, kinds, shift, eps, head_dim**-0.5,
    )
    return out, p, att, z


def fused_swin_block_train_backward(x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2, s1, s2,
                                    P, att, z, dout, kinds, num_heads, head_dim, window_size,
                                    eps=1e-5, shift=0):
    """The saved-P backward (TPU kernel #5): dx and the 13 parameter
    gradients, as `fused_swin_block_train_bwd_reference` returns them. On a
    CUDA tensor it launches the kernels of `csrc/fused_block_train.cu` (one
    counted call; every product on the tensor cores in 3xTF32, the window
    attention's on #10's saved-P stage); on a CPU tensor it runs the plain
    version. A bf16 x takes the bf16 form
    (`fused_swin_block_train_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        return fused_swin_block_train_backward_bf16(
            x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2, s1, s2, P, att, z, dout, kinds,
            num_heads, head_dim, window_size, eps, shift)
    if x.device.type == "cpu":
        return fused_swin_block_train_bwd_reference(
            x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2, s1, s2, P, att, z, dout, kinds,
            num_heads, head_dim, window_size, eps, shift,
        )
    name = "fused_swin_block_train_backward"
    _check_train_shapes(x, w1, kinds, num_heads, head_dim, window_size, shift, name)
    b, hh, ww, c = x.shape
    hidden, n, dev = w1.shape[1], window_size**2, x.device
    nwh, nww = hh // window_size, ww // window_size
    shapes = _param_shapes(c, hidden, kinds, num_heads, n)
    ops = dict(g1=g1, be1=be1, wq=wq, bq=bq, wp=wp, bp=bp, g2=g2, be2=be2, w1=w1, b1=b1, w2=w2,
               b2=b2)
    for k, t in ops.items():
        _check_cuda(k, t, shapes[k], dev)
    for k, t in (("x", x), ("att", att), ("z", z), ("dout", dout)):
        _check_cuda(k, t, (b, hh, ww, c), dev)
    _check_cuda("P", P, (b, nwh, nww, num_heads, n, n), dev)
    _check_cuda("s1", s1, (b,), dev)
    _check_cuda("s2", s2, (b,), dev)
    T = b * hh * ww

    def new(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    y, y2, dm, dz, dzp, datt = (new(T, c) for _ in range(6))
    stats1, stats2, qkv, dqkv = new(T, 2), new(T, 2), new(T, 3 * c), new(T, 3 * c)
    hg, dh = new(T, hidden), new(T, hidden)
    ds, dx = torch.empty_like(P), torch.empty_like(x)
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c)
    part = new(max(_part_floats(T, m, k)
                   for m, k in ((hidden, c), (c, hidden), (c, c), (c, 3 * c))))
    dln1, dln2, dbias = new(2 * c), new(2 * c), new(kinds, num_heads, n, n)
    dq, dp = new(c * 3 * c + 3 * c), new(c * c + c)
    d1, d2 = new(c * hidden + hidden), new(hidden * c + c)
    fused_swin_block_train_backward.launches += 1
    _launch(
        "fused_block_train", "trr_swin_block_bwd", dev,
        *(t.data_ptr() for t in (x, z, dout, P, att, g1, be1, wq, bq, wp, g2, be2, w1, b1, w2, s1,
                                 s2, y, stats1, y2, stats2, dm, hg, dh, dz, dzp, datt, qkv, dqkv,
                                 ds, ln_part, part, dx, dln1, dq, dp, dbias, dln2, d1, d2)),
        b, hh, ww, c, num_heads, hidden, kinds, shift, eps, head_dim**-0.5,
    )
    return (dx, *dln1.split(c), *_split_grad(dq, c, 3 * c), *_split_grad(dp, c, c), dbias,
            *dln2.split(c), *_split_grad(d1, c, hidden), *_split_grad(d2, hidden, c))


fused_swin_block_train_backward.launches = 0


def fused_swin_block_train_bf16(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1, s2,
                                num_heads, head_dim, window_size, eps=1e-5, shift=0):
    """#4's bf16 form: (out, P, att, z) of a bf16 x, all bf16, from the fp32
    parameters, as `fused_swin_block_train_bf16_reference` computes them.
    On a CUDA tensor it casts the four weights to bf16 and launches
    `trr_swin_block_fwd_bf16` (one counted call, seven launches); on a CPU
    tensor it runs the plain version. Its gate is the fp32 form's."""
    args = (x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1, s2, num_heads,
            head_dim, window_size, eps, shift)
    if x.device.type == "cpu":
        return fused_swin_block_train_bf16_reference(*args)
    name = "fused_swin_block_train_bf16"
    _check_train_shapes(x, w1, bias.shape[0], num_heads, head_dim, window_size, shift, name)
    b, hh, ww, c = x.shape
    hidden, kinds, n, dev = w1.shape[1], bias.shape[0], window_size**2, x.device
    shapes = _param_shapes(c, hidden, kinds, num_heads, n)
    ops = dict(g1=g1, be1=be1, wq=wq, bq=bq, wp=wp, bp=bp, bias=bias, g2=g2, be2=be2, w1=w1,
               b1=b1, w2=w2, b2=b2)
    _check_cuda("x", x, (b, hh, ww, c), dev, torch.bfloat16)
    for k, t in ops.items():
        _check_cuda(k, t, shapes[k], dev)
    _check_cuda("s1", s1, (b,), dev)
    _check_cuda("s2", s2, (b,), dev)
    ops.update({k: ops[k].to(torch.bfloat16) for k in ("wq", "wp", "w1", "w2")})
    _check_aligned(name, x=x, **ops)
    out, att, z = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    p = torch.empty((b, hh // window_size, ww // window_size, num_heads, n, n), device=dev,
                    dtype=torch.bfloat16)
    if x.numel() == 0:
        return out, p, att, z
    T = b * hh * ww  # scratch: LN1(x), then LN2(z); qkv; the MLP's hidden layer
    y, qkv, h = (torch.empty((T, k), device=dev, dtype=torch.bfloat16)
                 for k in (c, 3 * c, hidden))
    fused_swin_block_train_bf16.launches += 1
    _launch(
        "fused_block_train", "trr_swin_block_fwd_bf16", dev,
        x.data_ptr(), *(t.data_ptr() for t in ops.values()), s1.data_ptr(), s2.data_ptr(),
        *(t.data_ptr() for t in (y, qkv, h, out, p, att, z)),
        b, hh, ww, c, num_heads, hidden, kinds, shift, eps, head_dim**-0.5,
    )
    return out, p, att, z


fused_swin_block_train_bf16.launches = 0


def fused_swin_block_train_backward_bf16(x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2,
                                         s1, s2, P, att, z, dout, kinds, num_heads, head_dim,
                                         window_size, eps=1e-5, shift=0):
    """#5's bf16 form: dx (bf16) and the 13 parameter gradients (fp32) from
    the bf16 x, P, att, z and dout, as
    `fused_swin_block_train_bwd_bf16_reference` computes them. On a CUDA
    tensor it launches `trr_swin_block_bwd_bf16` (one counted call); on a
    CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return fused_swin_block_train_bwd_bf16_reference(
            x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2, s1, s2, P, att, z, dout, kinds,
            num_heads, head_dim, window_size, eps, shift)
    name = "fused_swin_block_train_backward_bf16"
    _check_train_shapes(x, w1, kinds, num_heads, head_dim, window_size, shift, name)
    b, hh, ww, c = x.shape
    hidden, n, dev = w1.shape[1], window_size**2, x.device
    nwh, nww = hh // window_size, ww // window_size
    shapes = _param_shapes(c, hidden, kinds, num_heads, n)
    ops = dict(g1=g1, be1=be1, wq=wq, bq=bq, wp=wp, g2=g2, be2=be2, w1=w1, b1=b1, w2=w2)
    for k, t in ops.items():
        _check_cuda(k, t, shapes[k], dev)
    for k, t in (("x", x), ("att", att), ("z", z), ("dout", dout)):
        _check_cuda(k, t, (b, hh, ww, c), dev, torch.bfloat16)
    _check_cuda("P", P, (b, nwh, nww, num_heads, n, n), dev, torch.bfloat16)
    _check_cuda("s1", s1, (b,), dev)
    _check_cuda("s2", s2, (b,), dev)
    ops.update({k: ops[k].to(torch.bfloat16) for k in ("wq", "wp", "w1", "w2")})
    _check_aligned(name, x=x, z=z, dout=dout, P=P, att=att, **ops)
    T = b * hh * ww

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    def half(*shape):
        return new(*shape, dtype=torch.bfloat16)

    y, y2, dm, dzp, datt = (half(T, c) for _ in range(5))
    dz, stats1, stats2 = new(T, c), new(T, 2), new(T, 2)
    hg, dh, dh32 = half(T, hidden), half(T, hidden), new(T, hidden)
    qkv, dqkv = half(T, 3 * c), half(T, 3 * c)
    ds, dx = new(*P.shape), torch.empty_like(x)
    ln_part = new(math.ceil(T / TC_ROWS), 2 * c)
    part = new(max(_part_floats_bf16(T, m, k)
                   for m, k in ((hidden, c), (c, hidden), (c, c), (c, 3 * c))))
    dln1, dln2, dbias = new(2 * c), new(2 * c), new(kinds, num_heads, n, n)
    dq, dp = new(c * 3 * c + 3 * c), new(c * c + c)
    d1, d2 = new(c * hidden + hidden), new(hidden * c + c)
    fused_swin_block_train_backward_bf16.launches += 1
    _launch(
        "fused_block_train", "trr_swin_block_bwd_bf16", dev,
        *(t.data_ptr() for t in (x, z, dout, P, att, g1, be1, ops["wq"], bq, ops["wp"], g2, be2,
                                 ops["w1"], b1, ops["w2"], s1, s2, y, stats1, y2, stats2, dm, hg,
                                 dh, dh32, dz, dzp, datt, qkv, dqkv, ds, ln_part, part, dx, dln1,
                                 dq, dp, dbias, dln2, d1, d2)),
        b, hh, ww, c, num_heads, hidden, kinds, shift, eps, head_dim**-0.5,
    )
    return (dx, *dln1.split(c), *_split_grad(dq, c, 3 * c), *_split_grad(dp, c, c), dbias,
            *dln2.split(c), *_split_grad(d1, c, hidden), *_split_grad(d2, hidden, c))


fused_swin_block_train_backward_bf16.launches = 0


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1, s2,
                num_heads, head_dim, window_size, eps, shift):
        args = (x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1, s2,
                num_heads, head_dim, window_size, eps, shift)
        if x.dtype == torch.bfloat16:
            out, p, att, z = fused_swin_block_train_bf16(*args)
        elif x.device.type == "cpu":
            out, p, att, z = fused_swin_block_train_reference(*args)
        else:
            out, p, att, z = _swin_block_train_fwd_cuda(*args)
        ctx.save_for_backward(x, g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2, s1, s2,
                              p, att, z)
        ctx.meta = (bias.shape[0], num_heads, head_dim, window_size, eps, shift)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = fused_swin_block_train_backward(*ctx.saved_tensors, dout.contiguous(),
                                                *ctx.meta)
        return (*grads, None, None, None, None, None, None, None)


def fused_swin_block_train(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1, s2,
                           num_heads, head_dim, window_size, eps=1e-5, shift=0):
    """out (B,H,W,C) = z + s2[b] * fc2(gelu(fc1(LN2 z))),
    z = x + s1[b] * proj(window-MHSA(qkv(LN1 x), bias)): the whole pre-LN Swin
    block for training, differentiable in x and the 13 parameters (not in
    s1, s2, whose gradient is None).

    Operands as `fused_attn_block` and `fused_ln_mlp` take them; the forward
    saves P, the attention output and z, and the backward computes every
    gradient from them (the saved-P backward). With shift > 0 the windows
    are those of x rolled by (-shift, -shift) and out comes back in x's
    frame, so the caller rolls nothing. On a CUDA tensor the forward
    launches `csrc/fused_block_train.cu` (one counted call); on a CPU tensor
    both directions run their plain versions. A bf16 x runs the bf16 forms
    (`fused_swin_block_train_bf16` and its backward): out and dx in bf16,
    the parameter gradients in fp32."""
    return _SwinBlockTrain.apply(x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2, s1,
                                 s2, num_heads, head_dim, window_size, eps, shift)


fused_swin_block_train.launches = 0
