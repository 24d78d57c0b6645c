"""Shifted-window multi-head self-attention: the CUDA kernels' wrappers,
their plain PyTorch versions, and the bias-kind helpers.

Port of the JAX package's ops/pallas/window_attention.py. Layout contract
(the same):

  qkv  (B, H, W, 3C): one Dense over NHWC, channel groups [q | k | v], each
       C = num_heads * head_dim with heads contiguous.
  bias (K, nh, n, n) fp32, n = wr * wc tokens of a window of wr rows and wc
       columns: relative-position bias plus the cyclic-shift mask. K = 1
       (unshifted: every window is kind 0) or 4 (shifted: interior / right
       edge / bottom edge / corner); the kind of a window is
       2 * is_bottom_row + is_rightmost_column.
  out  (B, H, W, C)

Two entries share the kernels of `csrc/window_attention.cu` (TPU kernel #3
forward, #8 backward), each counted on its own:

- `fused_window_mhsa(qkv, bias, nh, hd, window_size)`: square windows, 8x8
  (n = 64, SwinIR) and 16x16 (n = 256, HAT);
- `fused_rect_mhsa(qkv, bias, nh, hd, h_sp, w_sp)`: DAT's rectangles of
  h_sp rows and w_sp columns, n = 128 (8x16, 16x8) or 256 (8x32, 32x8).

Heads of at most 128 channels: a head of 65 to 128 (DRCT's 122 and 77)
takes the kernels' 128-wide form: its forward streams k and v of the whole
head through shared memory in tiles of keys, a block per window, head and
row block (`TC_ATTN_FWD_PLAN_128`), its backward a row pass, the head in
two 64-channel halves staged in turn (`TC_ATTN_PLANS_128`), and a key pass
(`TC_ATTN_KEY_PLAN_128`); a head of 33 to 64 (ATD's 35, DRCT's 53 and
46) the 64-wide form, its rows padded to 64 channels on plans of their own
(`TC_ATTN_PLANS_64`); heads of at most 32 the 32-wide form. Every form
lands on the same wrappers, and the wrappers count the 128-wide form's
launches apart too (`launches_hd128`). Both entries are
torch.autograd.Functions: on a
CUDA tensor the forward launches the forward kernel and the backward the
backward kernel (`csrc/tc_attn.cuh`'s tensor-core window attention, 3xTF32
on mma.sync: the forward is the pre-LN block forwards', the backward
shared with #6), which recomputes the softmax from qkv and the bias and
returns dqkv and dbias; on a CPU tensor both directions run their plain
versions (`fused_rect_mhsa_reference`, `fused_rect_mhsa_bwd_reference`, and
their square forms). Any other device, or a tensor the kernels do not take,
raises.

A bf16 qkv (a bf16 training step of HAT, DAT or SwinIR-L) takes the bf16
forms, computing as the JAX kernels do in qkv's dtype (bf16 mma.sync, fp32
sums and softmax, P and bf16(scale dS) rounded as operands, the outputs
rounded to bf16; the kind table, dS and dbias fp32), counted on their own:
`fused_window_mhsa_bf16`, `fused_rect_mhsa_bf16` and their `_backward_bf16`
wrappers, whose plain versions are the `*_bf16_reference` functions. The
bf16 backward at heads of up to 32 channels and the windows of
`GROUP_BWD_WINDOWS` (`window_bwd_grouped`) runs csrc/attn_group_bf16.cuh's
grouped kernels, which sum dbias inside the kernel over groups of one
kind's windows and allocate the groups' sums and the row stats
(`window_bwd_scratch_floats`) in place of a per-window dS.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# shared memory one thread block may use on sm_90 (bytes)
SMEM_LIMIT = 232_448
# the block kernels' tiles (csrc/common.cuh): 64 tokens (an 8x8 window),
# transposed tiles of row stride 68, v rows of 32 (so head_dim <= 32)
WINDOW = 8
WINDOWS = (8, 16)
RECT_TOKENS = (128, 256)  # n of the rect windows, besides the 8x8 window
TILE = 64
TILE_LD = 68
V_LD = 32
# the tensor-core window attention (csrc/tc_attn.cuh: #3, #8, and #1, #6 and
# #9's stage): rows of q, k, v and dA padded to 32 channels, HEAD_LD floats
# apart; window tokens n -> (query rows of a thread block, warps sharing a
# 16-row tile, each over its part of the keys)
HEAD_LD = 36
TC_ATTN_PLANS = {256: (64, 4), 144: (48, 2), 128: (32, 4), 64: (64, 2)}
# #3 and #8 at heads of 33 to 64 channels: rows padded to 64 channels, 68
# floats apart, and at n 256 rows of 32 (rows of 64 would need 243,712 B in
# the forward), one block of 8 warps a SM; tc_attn.cuh's attn_plan(n, 64)
TC_ATTN_PLANS_64 = {256: (32, 4), 128: (32, 4), 64: (64, 2)}
# #3 and #8 at heads of 65 to 128 channels. #8's row pass (one block per
# window, head and row block) takes the head in two 64-channel halves, each
# staged in turn into one (n, 68) room (k and v of a whole 128-wide head
# would need 270,336 B in fp32), on rows of 64 in two key parts at every n,
# one block of 8 warps a SM (tc_attn.cuh's attn_plan(n, 128)); #8's key
# pass (one block per window, head and block of keys) on blocks of 64 keys
# whose k rows stay staged whole, rows of 32 in four key parts, two blocks a
# SM (tc_attn.cuh's kWideKeyPlan: keys, rows, parts). #3 (one block per
# window, head and row block, 8 warps) streams k, then v, through two
# buffers of a tile of keys each, whole head rows (fp32 132 floats apart,
# bf16 136 elements), beside the (rows, n + 4) fp32 S / P tile: one block a
# SM in fp32, two in bf16 (tc_attn.cuh's kWideFwdPlan: rows, keys a tile)
HD_MAX = 128
TC_ATTN_PLANS_128 = {256: (64, 2), 128: (64, 2), 64: (64, 2)}
TC_ATTN_KEY_PLAN_128 = (64, 32, 4)
TC_ATTN_FWD_PLAN_128 = (64, 64)
# the 128-wide #3's layout by type (fp32, bf16): elements between two staged
# head rows (tc_attn.cuh's wide_fwd_ld), bytes an element, and blocks a SM
# (attn_wide_fwd_blocks, its __launch_bounds__)
WIDE_FWD_LD = {False: 132, True: 136}
WIDE_FWD_ELEMENT_BYTES = {False: 4, True: 2}
WIDE_FWD_BLOCKS = {False: 1, True: 2}
# #8's bf16 form at heads of up to 32 channels (csrc/attn_group_bf16.cuh):
# a block per head and group of windows of one kind, dbias summed in the
# kernel. At most GROUP_MAX_WINDOWS windows a group, the most whose grid
# fills two waves of GROUP_SMS SMs; at n 64 and 128 one launch
# (GROUP_BWD_BLOCKS blocks a SM), at n 256 a row pass and a key pass over
# blocks of PASS_ROWS rows or keys (ROW_PASS_THREADS and PASS_THREADS
# threads; ROW_PASS_BLOCKS and KEY_PASS_BLOCKS blocks a SM). Staged head
# rows GROUP_LD bf16 apart.
GROUP_BWD_WINDOWS = ((8, 8), (8, 16), (16, 8), (16, 16), (8, 32), (32, 8))
GROUP_MAX_WINDOWS, GROUP_SMS, GROUP_LD = 8, 132, 40
GROUP_BWD_BLOCKS = {64: 3, 128: 1, 144: 1}
PASS_N, PASS_ROWS, PASS_THREADS, ROW_PASS_THREADS = 256, 64, 128, 256
ROW_PASS_BLOCKS, KEY_PASS_BLOCKS = 1, 2


def head_width(head_dim: int) -> int:
    """The channels a head's staged rows pad to: 32, 64 for a head of 33 to
    64 channels, or 128 (two 64-channel halves) for one of 65 to 128 (#3
    and #8 only)."""
    return 32 if head_dim <= 32 else 64 if head_dim <= 64 else HD_MAX


def tc_attn_plan(n: int, head_dim: int = 32) -> tuple[int, int]:
    """(query rows of a thread block, warps a 16-row tile) at windows of n
    tokens and heads of head_dim channels, #3's and #8's (at heads past 64,
    #8's row pass; its key pass takes `TC_ATTN_KEY_PLAN_128`, the forward
    `TC_ATTN_FWD_PLAN_128`)."""
    return {32: TC_ATTN_PLANS, 64: TC_ATTN_PLANS_64, 128: TC_ATTN_PLANS_128}[
        head_width(head_dim)][n]


def rect_mhsa_smem_bytes(channels: int, num_heads: int, wr: int, wc: int) -> int:
    """Shared memory of the forward kernel (#3: the tensor-core window
    attention forward, heads of up to 128 channels) for windows of wr rows
    and wc columns."""
    return attn_fwd_tc_smem_bytes(wr * wc, channels // num_heads)


def attn_fwd_tc_smem_bytes(n: int, head_dim: int = 32) -> int:
    """Shared memory of the tensor-core window-attention forward
    (csrc/tc_attn.cuh) at windows of n tokens and heads of head_dim
    channels: k and v of the window and q and att of a row block, rows
    head_width + 4 floats apart (HEAD_LD at 32), the (rows, n + 4) P tile,
    two (parts, rows) exchanges of the key parts' row max and sum, and the n
    token indices; at heads past 64, the 128-wide form's fp32 size (its
    bf16 form's is smaller: `wide_fwd_smem_bytes`)."""
    if head_width(head_dim) == HD_MAX:
        return wide_fwd_smem_bytes(n)
    rb, ks = tc_attn_plan(n, head_dim)
    ld = head_width(head_dim) + 4
    return 4 * (2 * n * ld + 2 * rb * ld + rb * (n + 4) + 2 * ks * rb + n)


def wide_fwd_smem_bytes(n: int, bf16: bool = False) -> int:
    """Shared memory of the 128-wide #3 at windows of n tokens
    (csrc/tc_attn.cuh's attn_wide_fwd_smem_bytes): two buffers of a tile of
    keys' whole head rows (`WIDE_FWD_LD` elements apart), the (rows, n + 4)
    fp32 S / P tile and the n token indices."""
    rb, kt = TC_ATTN_FWD_PLAN_128
    row = WIDE_FWD_LD[bf16] * WIDE_FWD_ELEMENT_BYTES[bf16]
    return 2 * kt * row + 4 * rb * (n + 4) + 4 * n


def attn_bwd_tc_smem_bytes(n: int, att: bool, saved: bool = False, head_dim: int = 32) -> int:
    """Shared memory of the tensor-core window-attention backward
    (csrc/tc_attn.cuh) at windows of n tokens and heads of head_dim
    channels: k and v of the window and q and dA of a row block, rows
    head_width + 4 floats apart, the (rows, n + 4) P / dS tile, three
    (parts, rows) exchanges of the key parts' row sums (one, rowsum(P dP),
    in the `saved`-P form, #10's), the row block's dq rows (and, with `att`,
    #6's att rows) on their way out, and the n token indices."""
    rb, ks = tc_attn_plan(n, head_dim)
    if head_width(head_dim) == HD_MAX:
        # #8's 128-wide form (no att, no saved P): the larger of its passes'
        return max(wide_bwd_smem_bytes(n))
    ld = head_width(head_dim) + 4
    return 4 * (2 * n * ld + (4 if att else 3) * rb * ld + rb * (n + 4)
                + (1 if saved else 3) * ks * rb + n)


def wide_bwd_smem_bytes(n: int) -> tuple[int, int]:
    """Shared memory of the 128-wide #8's two passes at windows of n tokens
    (csrc/tc_attn.cuh): the row pass's one (n, 68) room for a k or v half,
    q, dA and dq halves of a row block, the (rows, n + 4) P / dS tile, three
    (parts, rows) exchanges and the n token indices; the key pass's whole k
    rows of its key block (keys, 132), q and dA rows of a row block (rows,
    132) each, the P and dS tiles (rows, keys + 4) and the n token
    indices."""
    rb, ks = TC_ATTN_PLANS_128[n]
    kb, r, _ = TC_ATTN_KEY_PLAN_128
    return (4 * (n * 68 + 3 * rb * 68 + rb * (n + 4) + 3 * ks * rb + n),
            4 * (kb * 132 + 2 * r * 132 + 2 * r * (kb + 4) + n))


def rect_mhsa_bwd_smem_bytes(channels: int, num_heads: int, wr: int, wc: int) -> int:
    """Shared memory of the backward kernel (#8: the tensor-core window
    attention without an att output; heads of up to 128 channels)."""
    return attn_bwd_tc_smem_bytes(wr * wc, att=False, head_dim=channels // num_heads)


def window_mhsa_smem_bytes(channels: int, num_heads: int, window_size: int = WINDOW) -> int:
    """Shared memory of the forward kernel at square windows."""
    return rect_mhsa_smem_bytes(channels, num_heads, window_size, window_size)


def window_mhsa_bwd_smem_bytes(channels: int, num_heads: int, window_size: int) -> int:
    """Shared memory of the backward kernel at square windows."""
    return rect_mhsa_bwd_smem_bytes(channels, num_heads, window_size, window_size)


def window_bwd_grouped(head_dim: int, wr: int, wc: int) -> bool:
    """#8's bf16 form takes csrc/attn_group_bf16.cuh's kernels at heads of
    up to 32 channels and the windows of GROUP_BWD_WINDOWS (the stated
    shape rule of window_bwd_grouped); tc_attn.cuh's take the rest."""
    return head_width(head_dim) == 32 and (wr, wc) in GROUP_BWD_WINDOWS


def kind_windows(b: int, nwh: int, nww: int, kinds: int, kind: int) -> list:
    """The windows of one bias kind in (sample, window row, window column)
    order (csrc/attn_group_bf16.cuh kind_grid)."""
    rows = nwh if kinds == 1 else 1 if kind & 2 else nwh - 1
    cols = nww if kinds == 1 else 1 if kind & 1 else nww - 1
    wins = []
    for m in range(b * rows * cols):
        r = m % (rows * cols)
        wi = nwh - 1 if kinds == 4 and kind & 2 else r // cols
        wj = nww - 1 if kinds == 4 and kind & 1 else r % cols
        wins.append((m // (rows * cols), wi, wj))
    return wins


def group_offsets(b: int, nwh: int, nww: int, kinds: int, windows: int) -> list[int]:
    """goff of csrc/attn_group_bf16.cuh attn_groups: the first group of
    each kind, then the total, `windows` windows a group."""
    goff = [0]
    for kind in range(4):
        count = len(kind_windows(b, nwh, nww, kinds, kind)) if kind < kinds else 0
        goff.append(goff[-1] + -(-count // windows))
    return goff


def group_windows(b: int, nwh: int, nww: int, kinds: int, per_group: int, per_sm: int) -> int:
    """Windows a group: the most, up to GROUP_MAX_WINDOWS, whose grid of
    `per_group` blocks a group fills two waves of `per_sm` blocks a SM; 1
    if none does (group_windows)."""
    for gw in range(GROUP_MAX_WINDOWS, 1, -1):
        if group_offsets(b, nwh, nww, kinds, gw)[4] * per_group >= 2 * GROUP_SMS * per_sm:
            return gw
    return 1


def window_bwd_group_windows(b, hh, ww, num_heads, kinds, wr, wc, pass_: int = 0) -> int:
    """Windows a group of #8's grouped bf16 grids: pass 0 the one launch at
    n 64 and 128, or the row pass at n 256; pass 1 the key pass."""
    n, nwh, nww = wr * wc, hh // wr, ww // wc
    if n == PASS_N:
        return group_windows(b, nwh, nww, kinds, num_heads * (PASS_N // PASS_ROWS),
                             KEY_PASS_BLOCKS if pass_ else ROW_PASS_BLOCKS)
    return group_windows(b, nwh, nww, kinds, num_heads, GROUP_BWD_BLOCKS[n])


def window_bwd_scratch_floats(b, hh, ww, num_heads, kinds, wr, wc) -> tuple[int, int]:
    """Floats of #8's grouped bf16 scratch: the groups' dbias sums (groups,
    nh, n, n) and, at n 256, the row stats (B, nwh, nww, nh, n, 4)."""
    n, nwh, nww = wr * wc, hh // wr, ww // wc
    gw = window_bwd_group_windows(b, hh, ww, num_heads, kinds, wr, wc)
    groups = group_offsets(b, nwh, nww, kinds, gw)[4]
    return groups * num_heads * n * n, (4 * b * nwh * nww * num_heads * n if n == PASS_N else 0)


def window_bwd_smem_bytes(n: int) -> int:
    """Shared memory of csrc/attn_group_bf16.cuh's attn_window_bwd_bf16_kernel
    (#8 at n 64 and 128): the (n, n) fp32 dbias sums, two windows' rooms of
    q, k, v and dA (n rows each), the (n, n + 8) bf16 P / dS tile, and a
    byte a staged row."""
    return 4 * n * n + 2 * 2 * 4 * n * GROUP_LD + 2 * n * (n + 8) + 4 * n


def rows_pass_smem_bytes() -> int:
    """The row pass's: the (64, 256) fp32 sums, two windows' rooms of 64 q
    and dA and 256 k and v rows, the key halves' (3, 2, 64) row values and
    (64, 32) dq sums, a byte a staged row."""
    return (4 * PASS_ROWS * PASS_N + 2 * 2 * (2 * PASS_ROWS + 2 * PASS_N) * GROUP_LD
            + 4 * (3 * 2 * PASS_ROWS + 32 * PASS_ROWS) + 2 * PASS_ROWS + 2 * PASS_N)


def keys_pass_smem_bytes() -> int:
    """The key pass's: two windows' rooms of 256 q and dA and 64 k and v
    rows, two windows' row stats (float4), a byte a staged row."""
    return (2 * 2 * (2 * PASS_N + 2 * PASS_ROWS) * GROUP_LD + 2 * 16 * PASS_N + 2 * PASS_N
            + 2 * PASS_ROWS)


def heads_fit(window_size: int, channels: int, num_heads: int) -> bool:
    """8x8 windows and heads of at most 32 channels: the block kernels'
    tiles (Swin2SR's #11-#14, whose window attention keeps the 32-wide
    rows; the 64-wide form is #3 and #8's alone)."""
    return (
        window_size == WINDOW
        and channels % num_heads == 0
        and channels // num_heads <= V_LD
    )


def rect_mhsa_fits(h: int, w: int, wr: int, wc: int, channels: int, num_heads: int) -> bool:
    """The window kernels' limits: 8x8 windows or windows of 128 or 256
    tokens, H a multiple of wr and W of wc, heads of at most 128 channels
    (HD_MAX; 33 to 64 on the 64-wide form, 65 to 128 on the 128-wide one),
    and the forward's and backward's shared-memory plans within one thread
    block's."""
    if not (wr == wc == WINDOW or wr * wc in RECT_TOKENS) or h % wr or w % wc:
        return False
    if channels % num_heads or channels // num_heads > HD_MAX:
        return False
    return max(rect_mhsa_smem_bytes(channels, num_heads, wr, wc),
               rect_mhsa_bwd_smem_bytes(channels, num_heads, wr, wc)) <= SMEM_LIMIT


def window_mhsa_fits(h: int, w: int, window_size: int, channels: int, num_heads: int) -> bool:
    """`rect_mhsa_fits` for square windows: 8x8 or 16x16, heads of up to
    128 channels."""
    return window_size in WINDOWS and rect_mhsa_fits(h, w, window_size, window_size, channels,
                                                     num_heads)


def _attn_kernels_on() -> bool:
    return os.environ.get("TRAINNER_FUSED_ATTN", "1") != "0"


def fused_window_mhsa_supported(
    h: int, w: int, window_size: int, channels: int, num_heads: int
) -> bool:
    """Whether a block's attention takes the kernels (SwinBlock's unfused
    branch, HAB): within their limits, unless TRAINNER_FUSED_ATTN=0 (the
    global off switch)."""
    return _attn_kernels_on() and window_mhsa_fits(h, w, window_size, channels, num_heads)


def fused_rect_mhsa_supported(
    h: int, w: int, h_sp: int, w_sp: int, channels: int, num_heads: int
) -> bool:
    """Whether a DAT spatial-attention branch takes the kernels: within their
    limits (`rect_mhsa_fits`), unless TRAINNER_FUSED_ATTN=0. The device is
    not checked: on a CPU tensor the wrapper runs its plain versions."""
    return _attn_kernels_on() and rect_mhsa_fits(h, w, h_sp, w_sp, channels, num_heads)


def rect_shift_mask_kinds(h_sp: int, w_sp: int, sh: int, sw: int) -> np.ndarray:
    """The 4 distinct cyclic-shift attention masks (kind, n, n) fp32 of
    windows of h_sp rows and w_sp columns on a map rolled by (-sh, -sw):
    0 interior, 1 right-edge column, 2 bottom-edge row, 3 bottom-right
    corner. In an edge window the last sh rows (sw columns) wrapped around
    from the opposite image edge; windows not touching the wrapped edge see
    an all-zero mask. Masked pairs get -100 (not -inf), as upstream."""
    n = h_sp * w_sp
    row_edge = np.zeros((h_sp,), np.int32)
    row_edge[h_sp - sh :] = 1
    col_edge = np.zeros((w_sp,), np.int32)
    col_edge[w_sp - sw :] = 1
    row_int = np.zeros((h_sp,), np.int32)
    col_int = np.zeros((w_sp,), np.int32)
    masks = np.zeros((4, n, n), np.float32)
    for kind, (rs, cs) in enumerate(
        [(row_int, col_int), (row_int, col_edge), (row_edge, col_int), (row_edge, col_edge)]
    ):
        seg = (rs[:, None] * 2 + cs[None, :]).reshape(-1)  # (n,)
        masks[kind] = np.where(seg[:, None] != seg[None, :], -100.0, 0.0)
    return masks


def shift_mask_kinds(window_size: int, shift: int) -> np.ndarray:
    """The square windows' 4 shift masks (kind, n, n); equivalent to upstream
    SwinIR's calculate_mask evaluated per window position."""
    return rect_shift_mask_kinds(window_size, window_size, shift, shift)


def window_kinds(nwh: int, nww: int, kinds: int, device=None) -> torch.Tensor:
    """(nwh * nww,) kind of each window, row-major over the window grid."""
    if kinds == 1:
        return torch.zeros(nwh * nww, dtype=torch.long, device=device)
    i = torch.arange(nwh, device=device)[:, None]
    j = torch.arange(nww, device=device)[None, :]
    return (2 * (i == nwh - 1) + (j == nww - 1)).reshape(-1).long()


def _bf(t):
    """t rounded to bf16 and held in fp32 for the arithmetic that follows:
    the JAX kernel's `.astype(bf16)` between its fp32 steps."""
    return t.to(torch.bfloat16).float()


def rect_partition(t: torch.Tensor, wr: int, wc: int) -> torch.Tensor:
    """(B, H, W, X) -> (B, nW, wr * wc, X), windows of wr rows and wc
    columns, row-major."""
    b, hh, ww, _ = t.shape
    t = t.reshape(b, hh // wr, wr, ww // wc, wc, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, (hh // wr) * (ww // wc), wr * wc, -1)


def rect_reverse(t: torch.Tensor, hh: int, ww: int, wr: int, wc: int) -> torch.Tensor:
    """(B, nW, wr * wc, X) -> (B, H, W, X), the inverse of `rect_partition`."""
    b = t.shape[0]
    t = t.reshape(b, hh // wr, ww // wc, wr, wc, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, hh, ww, -1)


def reference_rect_mhsa(qkv, bias_full, num_heads, head_dim, wr, wc,
                        scale: float | None = None):
    """Plain PyTorch window MHSA over windows of wr rows and wc columns with
    a per-window bias bias_full (nW or 1, nh, n, n), already including any
    shift mask; the scores scaled by `scale`, head_dim**-0.5 by default. A
    bf16 qkv computes as flax's plain attention in bf16: bf16(q scale) k and
    the softmax in fp32, P rounded to bf16, P v rounded to bf16."""
    _, hh, ww, _ = qkv.shape
    x = rect_partition(qkv, wr, wc).unflatten(-1, (3, num_heads, head_dim))
    q, k, v = x.permute(3, 0, 1, 4, 2, 5).float()  # each (b, nw, nh, n, hd)
    scale = scale or head_dim**-0.5
    if qkv.dtype == torch.bfloat16:
        s = torch.einsum("bwhnd,bwhmd->bwhnm", _bf(q * scale), k) + bias_full[None].float()
        p = _bf(torch.softmax(s, dim=-1))
    else:
        s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) * scale + bias_full[None].float()
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhnm,bwhmd->bwhnd", p, v)
    return rect_reverse(o.transpose(2, 3).flatten(-2), hh, ww, wr, wc).to(qkv.dtype)


def reference_window_mhsa(qkv, bias_full, num_heads, head_dim, window_size):
    """`reference_rect_mhsa` at square windows."""
    return reference_rect_mhsa(qkv, bias_full, num_heads, head_dim, window_size, window_size)


def fused_rect_mhsa_reference(qkv, bias, num_heads, head_dim, h_sp, w_sp):
    """The forward kernel's spec: window MHSA with the (K, nh, n, n) kind
    table, windows of h_sp rows and w_sp columns."""
    _, hh, ww, _ = qkv.shape
    idx = window_kinds(hh // h_sp, ww // w_sp, bias.shape[0], device=bias.device)
    return reference_rect_mhsa(qkv, bias[idx], num_heads, head_dim, h_sp, w_sp)


def fused_window_mhsa_reference(qkv, bias, num_heads, head_dim, window_size):
    """`fused_rect_mhsa_reference` at square windows."""
    return fused_rect_mhsa_reference(qkv, bias, num_heads, head_dim, window_size, window_size)


def _window_heads(t, num_heads, h_sp, w_sp):
    """(B, H, W, nh*hd) -> (B, nW, nh, n, hd) in fp32."""
    return rect_partition(t.float(), h_sp, w_sp).unflatten(-1, (num_heads, -1)).transpose(2, 3)


def _window_softmax(qkv, bias, num_heads, head_dim, h_sp, w_sp):
    """(P, q, k, v, kind) of the windows: P the fp32 softmax of q k^T scale
    plus each window's kind table, q, k, v (B, nW, nh, n, hd) in fp32."""
    _, hh, ww, _ = qkv.shape
    q, k, v = (_window_heads(t, num_heads, h_sp, w_sp) for t in qkv.chunk(3, dim=-1))
    kind = window_kinds(hh // h_sp, ww // w_sp, bias.shape[0], device=bias.device)
    p = torch.softmax(q @ k.transpose(-1, -2) * head_dim**-0.5 + bias.float()[kind], dim=-1)
    return p, q, k, v, kind


def fused_rect_mhsa_bf16_reference(qkv, bias, num_heads, head_dim, h_sp, w_sp):
    """#3's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (ops/pallas/window_attention.py:191-220): S = q k^T from the bf16 q, k
    summed in fp32, S scale + bias and the softmax in fp32, P rounded to
    bf16, att = bf16(P) v summed in fp32 and rounded to bf16."""
    _, hh, ww, _ = qkv.shape
    p, _, _, v, _ = _window_softmax(qkv, bias, num_heads, head_dim, h_sp, w_sp)
    o = _bf(p) @ v
    return rect_reverse(o.transpose(2, 3).flatten(-2), hh, ww, h_sp, w_sp).to(torch.bfloat16)


def fused_window_mhsa_bf16_reference(qkv, bias, num_heads, head_dim, window_size):
    """`fused_rect_mhsa_bf16_reference` at square windows."""
    return fused_rect_mhsa_bf16_reference(qkv, bias, num_heads, head_dim, window_size,
                                          window_size)


def fused_rect_mhsa_bwd_bf16_reference(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp):
    """#8's bf16 form, step by step in fp32 with the JAX kernel's roundings
    (ops/pallas/window_attention.py:226-300): P recomputed in fp32, dv =
    bf16(P)^T dout; dP = dout v^T and dS = P (dP - rowsum(P dP)) in fp32,
    dbias summing the fp32 dS; dq and dk from bf16(scale dS); dq, dk, dv
    rounded to bf16. Returns (dqkv bf16, dbias fp32)."""
    _, hh, ww, _ = qkv.shape
    n, kinds = h_sp * w_sp, bias.shape[0]
    p, q, k, v, kind = _window_softmax(qkv, bias, num_heads, head_dim, h_sp, w_sp)
    do = _window_heads(dout, num_heads, h_sp, w_sp)
    dv = _bf(_bf(p).transpose(-1, -2) @ do)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = _bf(ds * head_dim**-0.5)
    dq, dk = _bf(ds_lo @ k), _bf(ds_lo.transpose(-1, -2) @ q)
    dbias = torch.zeros(kinds, num_heads, n, n, dtype=torch.float32, device=qkv.device)
    dbias.index_add_(0, kind, ds.sum(0))
    dqkv = torch.cat([t.transpose(2, 3).flatten(-2) for t in (dq, dk, dv)], dim=-1)
    return rect_reverse(dqkv, hh, ww, h_sp, w_sp).to(torch.bfloat16), dbias


def fused_window_mhsa_bwd_bf16_reference(qkv, bias, dout, num_heads, head_dim, window_size):
    """`fused_rect_mhsa_bwd_bf16_reference` at square windows."""
    return fused_rect_mhsa_bwd_bf16_reference(qkv, bias, dout, num_heads, head_dim, window_size,
                                              window_size)


def fused_rect_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp):
    """The backward kernel's spec, step by step, in fp32: (dqkv (B,H,W,3C),
    dbias (K,nh,n,n)) of `fused_rect_mhsa_reference` for the output gradient
    dout (B,H,W,C), the softmax recomputed from qkv and the bias."""
    _, hh, ww, _ = qkv.shape
    n, kinds = h_sp * w_sp, bias.shape[0]
    p, q, k, v, kind = _window_softmax(qkv, bias, num_heads, head_dim, h_sp, w_sp)
    do = _window_heads(dout, num_heads, h_sp, w_sp)
    scale = head_dim**-0.5
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq, dk = ds @ k * scale, ds.transpose(-1, -2) @ q * scale
    dbias = torch.zeros(kinds, num_heads, n, n, dtype=torch.float32, device=qkv.device)
    dbias.index_add_(0, kind, ds.sum(0))
    dqkv = torch.cat([t.transpose(2, 3).flatten(-2) for t in (dq, dk, dv)], dim=-1)
    return rect_reverse(dqkv, hh, ww, h_sp, w_sp).to(qkv.dtype), dbias.to(bias.dtype)


def fused_window_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, window_size):
    """`fused_rect_mhsa_bwd_reference` at square windows."""
    return fused_rect_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, window_size,
                                         window_size)


def _check_cuda(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    """Placement, type (float32 unless a bf16 form asks for bfloat16), shape
    and contiguity of a kernel operand; raises on anything else, so a bf16
    tensor that reaches an fp32-only kernel raises and is never cast."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, the other operands on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {str(dtype).removeprefix('torch.')}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


# the largest y and z of a launch grid: the kernels that take the windows of
# an image on y and the images on z (every backward, and the 128-wide
# forward) take at most this many of each
GRID_YZ_MAX = 65535


def _check_window_shapes(name, qkv, bias, num_heads, head_dim, wr, wc,
                         dtype=torch.float32, grid_yz=True):
    """Refuse, with its limits, a call outside the kernels' gate; `grid_yz`:
    the launch puts windows on the grid's y and images on its z."""
    b, hh, ww, c3 = qkv.shape
    c, n, kinds = num_heads * head_dim, wr * wc, bias.shape[0]
    if c3 != 3 * c or kinds not in (1, 4):
        raise ValueError(f"qkv {tuple(qkv.shape)} / bias {tuple(bias.shape)} do not match")
    _check_cuda("qkv", qkv, (b, hh, ww, 3 * c), qkv.device, dtype)
    _check_cuda("bias", bias, (kinds, num_heads, n, n), qkv.device)
    if not rect_mhsa_fits(hh, ww, wr, wc, c, num_heads):
        raise ValueError(
            f"{name}: H={hh}, W={ww}, C={c}, heads={num_heads}, windows {wr}x{wc} "
            f"is outside the kernels' limits (windows of 64, 128 or 256 tokens dividing the "
            f"map, heads of at most {HD_MAX} channels)"
        )
    if b * hh * ww * 3 * c >= 2**31:
        raise ValueError(f"{name}: {b * hh * ww} tokens are more than the kernels index")
    windows = (hh // wr) * (ww // wc)
    if grid_yz and max(b, windows) > GRID_YZ_MAX:
        raise ValueError(f"{name}: {b} images of {windows} windows is outside the kernel's "
                         f"launch grid (at most {GRID_YZ_MAX} of each)")


def _mhsa_fwd_cuda(counted, qkv, bias, num_heads, head_dim, wr, wc, bf16=False):
    """Launch the forward kernel (`bf16`: its bf16 form), one count on the
    wrapper `counted`."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    _check_window_shapes(counted.__name__, qkv, bias, num_heads, head_dim, wr, wc, dtype,
                         grid_yz=head_width(head_dim) == HD_MAX)
    b, hh, ww, _ = qkv.shape
    c = num_heads * head_dim
    out = torch.empty((b, hh, ww, c), device=qkv.device, dtype=qkv.dtype)
    if out.numel() == 0:
        return out
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("window_attention")
    fn = lib.trr_rect_mhsa_fwd_bf16 if bf16 else lib.trr_rect_mhsa_fwd
    with torch.cuda.device(qkv.device):
        counted.launches += 1
        counted.launches_hd128 += head_width(head_dim) == HD_MAX
        status = fn(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, hh, ww, c, num_heads, bias.shape[0], wr, wc, head_dim**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, counted.__name__)
    return out


def _mhsa_bwd_cuda(counted, qkv, bias, dout, num_heads, head_dim, wr, wc, bf16=False):
    """Launch the backward kernel (`bf16`: its bf16 form) and the bias-kind
    reduction, one count on the wrapper `counted`."""
    name = counted.__name__
    dtype = torch.bfloat16 if bf16 else torch.float32
    _check_window_shapes(name, qkv, bias, num_heads, head_dim, wr, wc, dtype)
    b, hh, ww, _ = qkv.shape
    c, n, kinds = num_heads * head_dim, wr * wc, bias.shape[0]
    _check_cuda("dout", dout, (b, hh, ww, c), qkv.device, dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    from trainner_redux_tpu_torch.ops import cuda_build

    lib = cuda_build.library("window_attention")
    wide = head_width(head_dim) == HD_MAX
    if bf16 and window_bwd_grouped(head_dim, wr, wc):
        # the groups' dbias sums and, at n 256, each row's softmax stats
        # (csrc/attn_group_bf16.cuh): no per-window dS
        if b * (hh // wr) * (ww // wc) > GRID_YZ_MAX:
            raise ValueError(f"{name}: {b * (hh // wr) * (ww // wc)} windows is outside the "
                             f"kernel's launch grid (at most {GRID_YZ_MAX} groups)")
        ds, stats = (torch.empty((lib.trr_rect_mhsa_bwd_bf16_scratch_floats(
            b, hh, ww, num_heads, kinds, wr, wc, which),), device=qkv.device,
            dtype=torch.float32) for which in (0, 1))
    else:
        # dS of every window and head, which the bias-kind reduction sums
        ds = torch.empty((b, hh // wr, ww // wc, num_heads, n, n), device=qkv.device,
                         dtype=torch.float32)
        # the 128-wide form's softmax max and inverse sum of every row, from
        # its row pass to its key pass
        stats = torch.empty((b, hh // wr, ww // wc, num_heads, n, 2) if wide else (0,),
                            device=qkv.device, dtype=torch.float32)
    fn = lib.trr_rect_mhsa_bwd_bf16 if bf16 else lib.trr_rect_mhsa_bwd
    with torch.cuda.device(qkv.device):
        counted.launches += 1
        counted.launches_hd128 += wide
        status = fn(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), ds.data_ptr(),
            stats.data_ptr(), dbias.data_ptr(), b, hh, ww, c, num_heads, kinds, wr, wc,
            head_dim**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, name)
    return dqkv, dbias


def fused_window_mhsa_backward(qkv, bias, dout, num_heads, head_dim, window_size):
    """(dqkv, dbias) of `fused_window_mhsa` for the output gradient dout
    (TPU kernel #8). On a CUDA tensor it launches the backward kernel (five
    products on the tensor cores in 3xTF32) and the bias-kind reduction of
    `csrc/window_attention.cu` (one counted call); on a CPU tensor it runs
    the plain version. A bf16 qkv takes the bf16 form
    (`fused_window_mhsa_backward_bf16`)."""
    if qkv.dtype == torch.bfloat16:
        return fused_window_mhsa_backward_bf16(qkv, bias, dout, num_heads, head_dim, window_size)
    if qkv.device.type == "cpu":
        return fused_window_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, window_size)
    return _mhsa_bwd_cuda(fused_window_mhsa_backward, qkv, bias, dout, num_heads, head_dim,
                          window_size, window_size)


def fused_rect_mhsa_backward(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp):
    """(dqkv, dbias) of `fused_rect_mhsa` for the output gradient dout (TPU
    kernel #8's rect form). On a CUDA tensor it launches the backward kernel
    and the bias-kind reduction (one counted call); on a CPU tensor it runs
    the plain version. A bf16 qkv takes the bf16 form
    (`fused_rect_mhsa_backward_bf16`)."""
    if qkv.dtype == torch.bfloat16:
        return fused_rect_mhsa_backward_bf16(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp)
    if qkv.device.type == "cpu":
        return fused_rect_mhsa_bwd_reference(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp)
    return _mhsa_bwd_cuda(fused_rect_mhsa_backward, qkv, bias, dout, num_heads, head_dim,
                          h_sp, w_sp)


fused_window_mhsa_backward.launches = 0
fused_rect_mhsa_backward.launches = 0
fused_window_mhsa_backward.launches_hd128 = 0
fused_rect_mhsa_backward.launches_hd128 = 0


def fused_window_mhsa_bf16(qkv, bias, num_heads, head_dim, window_size):
    """#3's bf16 form at square windows (8x8, 16x16): out (B, H, W, C) bf16
    from a bf16 qkv and the fp32 kind table, as
    `fused_window_mhsa_bf16_reference` computes it. On a CUDA tensor it
    launches `trr_rect_mhsa_fwd_bf16` (one counted call); on a CPU tensor it
    runs the plain version. Its limits are the fp32 form's
    (`rect_mhsa_fits`); a tensor outside them raises."""
    if qkv.device.type == "cpu":
        return fused_window_mhsa_bf16_reference(qkv, bias, num_heads, head_dim, window_size)
    return _mhsa_fwd_cuda(fused_window_mhsa_bf16, qkv, bias, num_heads, head_dim, window_size,
                          window_size, bf16=True)


def fused_rect_mhsa_bf16(qkv, bias, num_heads, head_dim, h_sp, w_sp):
    """#3's bf16 form at DAT's rect windows, as `fused_window_mhsa_bf16`."""
    if qkv.device.type == "cpu":
        return fused_rect_mhsa_bf16_reference(qkv, bias, num_heads, head_dim, h_sp, w_sp)
    return _mhsa_fwd_cuda(fused_rect_mhsa_bf16, qkv, bias, num_heads, head_dim, h_sp, w_sp,
                          bf16=True)


def fused_window_mhsa_backward_bf16(qkv, bias, dout, num_heads, head_dim, window_size):
    """#8's bf16 form at square windows: (dqkv bf16, dbias fp32) from the
    bf16 qkv and dout, as `fused_window_mhsa_bwd_bf16_reference` computes
    them. On a CUDA tensor it launches `trr_rect_mhsa_bwd_bf16` and the
    bias-kind reduction (one counted call); on a CPU tensor it runs the
    plain version."""
    if qkv.device.type == "cpu":
        return fused_window_mhsa_bwd_bf16_reference(qkv, bias, dout, num_heads, head_dim,
                                                    window_size)
    return _mhsa_bwd_cuda(fused_window_mhsa_backward_bf16, qkv, bias, dout, num_heads, head_dim,
                          window_size, window_size, bf16=True)


def fused_rect_mhsa_backward_bf16(qkv, bias, dout, num_heads, head_dim, h_sp, w_sp):
    """#8's bf16 form at DAT's rect windows, as
    `fused_window_mhsa_backward_bf16`."""
    if qkv.device.type == "cpu":
        return fused_rect_mhsa_bwd_bf16_reference(qkv, bias, dout, num_heads, head_dim, h_sp,
                                                  w_sp)
    return _mhsa_bwd_cuda(fused_rect_mhsa_backward_bf16, qkv, bias, dout, num_heads, head_dim,
                          h_sp, w_sp, bf16=True)


fused_window_mhsa_bf16.launches = 0
fused_rect_mhsa_bf16.launches = 0
fused_window_mhsa_backward_bf16.launches = 0
fused_rect_mhsa_backward_bf16.launches = 0
fused_window_mhsa_bf16.launches_hd128 = 0
fused_rect_mhsa_bf16.launches_hd128 = 0
fused_window_mhsa_backward_bf16.launches_hd128 = 0
fused_rect_mhsa_backward_bf16.launches_hd128 = 0


class _WindowMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, head_dim, window_size):
        if qkv.dtype == torch.bfloat16:
            out = fused_window_mhsa_bf16(qkv, bias, num_heads, head_dim, window_size)
        elif qkv.device.type == "cpu":
            out = fused_window_mhsa_reference(qkv, bias, num_heads, head_dim, window_size)
        else:
            out = _mhsa_fwd_cuda(fused_window_mhsa, qkv, bias, num_heads, head_dim,
                                 window_size, window_size)
        ctx.save_for_backward(qkv, bias)
        ctx.meta = (num_heads, head_dim, window_size)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = fused_window_mhsa_backward(qkv, bias, dout.contiguous(), *ctx.meta)
        return dqkv, dbias, None, None, None


class _RectMhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, head_dim, h_sp, w_sp):
        if qkv.dtype == torch.bfloat16:
            out = fused_rect_mhsa_bf16(qkv, bias, num_heads, head_dim, h_sp, w_sp)
        elif qkv.device.type == "cpu":
            out = fused_rect_mhsa_reference(qkv, bias, num_heads, head_dim, h_sp, w_sp)
        else:
            out = _mhsa_fwd_cuda(fused_rect_mhsa, qkv, bias, num_heads, head_dim, h_sp, w_sp)
        ctx.save_for_backward(qkv, bias)
        ctx.meta = (num_heads, head_dim, h_sp, w_sp)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = fused_rect_mhsa_backward(qkv, bias, dout.contiguous(), *ctx.meta)
        return dqkv, dbias, None, None, None, None


def fused_window_mhsa(qkv, bias, num_heads, head_dim, window_size):
    """out (B,H,W,C) = window-MHSA(qkv (B,H,W,3C), bias (K,nh,n,n)),
    differentiable in qkv and bias.

    On a CUDA tensor the forward launches TPU kernel #3's port (ws 8 or 16)
    and the backward #8's (`fused_window_mhsa_backward`); on a CPU tensor
    both run their plain versions. A bf16 qkv runs the bf16 forms (out and
    dqkv in bf16, dbias in fp32)."""
    return _WindowMhsa.apply(qkv, bias, num_heads, head_dim, window_size)


def fused_rect_mhsa(qkv, bias, num_heads, head_dim, h_sp, w_sp):
    """out (B,H,W,C) = rect-window MHSA(qkv (B,H,W,3C), bias (K,nh,n,n)),
    windows of h_sp rows and w_sp columns, n = h_sp * w_sp; differentiable in
    qkv and bias.

    On a CUDA tensor the forward launches the rect form of TPU kernel #3 and
    the backward that of #8 (`fused_rect_mhsa_backward`); on a CPU tensor
    both run their plain versions. A bf16 qkv runs the bf16 forms."""
    return _RectMhsa.apply(qkv, bias, num_heads, head_dim, h_sp, w_sp)


fused_window_mhsa.launches = 0
fused_rect_mhsa.launches = 0
fused_window_mhsa.launches_hd128 = 0
fused_rect_mhsa.launches_hd128 = 0

