"""The plans of the port's bf16 weight-gradient stage (csrc/wgrad_bf16.cuh)
and of #6's bf16 window attention over groups of windows
(csrc/attn_group_bf16.cuh), on the CPU, where neither kernel runs.

- #6's dbias as the kernel sums it: the per-window dS of every head in fp32,
  each group of the kind's windows added in order, then the groups in order
  (`_dbias_grouped`, the windows of `tfb.attn_dbias_groups`), against the
  dbias of `jax.vjp` of the JAX package's fused_attn_block (Pallas in
  interpret mode, fp32) at 12x12 windows (n 144) on a 48x60 map of 20
  windows, no multiple of a group: K=1 unshifted (groups of 8, 8, 4) and K=4
  shifted by 6 (12 interior windows, 3, 4 and 1); within 1e-4 of the
  largest.
- The weight-gradient stage's token ranges, partial products and the
  partial rows of its bias sums, added in its order
  (`_wg_blocked`), against float64 at C 180 and 240 (#5's
  (360, 180) and (180, 540), #6's (240, 240) and (240, 720)) with a ragged T
  of 1,000 tokens: the sums of B itself and of an fp32 source times the
  DropPath scale of its sample, within 1e-5 of the largest.
- The Python mirrors of both kernels' plans (shared memory, tiles, groups,
  copy units) against the constants and rules that the sources are built
  from.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block as tfb
from trainner_redux_tpu_torch.ops.window_attention import SMEM_LIMIT

B, HH, WW, NH, HD, WS = 1, 48, 60, 2, 16, 12
C, N = NH * HD, WS * WS
S = np.asarray([0.8], np.float32)
CSRC = Path(tfb.__file__).resolve().parents[1] / "csrc"


def _params(rng, kinds):
    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    rel = normal(NH, N, N, scale=0.1)
    bias = rel[None] + (shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0)
    return {
        "x": normal(B, HH, WW, C), "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=0.3), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=0.3), "bp": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(bias, dtype=np.float32), "dout": normal(B, HH, WW, C),
    }


def _dbias_grouped(ds, kinds: int):
    """dbias (K, nh, n, n) from the per-window dS (B, nwh, nww, nh, n, n) in
    fp32 as #6's bf16 window attention sums it: each group's windows in
    order into the group's sums, then each kind's groups in order
    (dbias_group_sum_kernel)."""
    b, nwh, nww, nh, n, _ = ds.shape
    dbias = torch.zeros(kinds, nh, n, n, dtype=torch.float32, device=ds.device)
    for kind, wins in tfb.attn_dbias_groups(b, nwh, nww, kinds):
        acc = torch.zeros(nh, n, n, dtype=torch.float32, device=ds.device)
        for bi, wi, wj in wins:
            acc = acc + ds[bi, wi, wj].float()
        dbias[kind] = dbias[kind] + acc
    return dbias


def _wg_blocked(a, bmat, sums=None, row_scale=None):
    """The bf16 weight-gradient stage's sums in its order, on the CPU: (A^T
    B, the bias sums) of a (T, M) and bmat (T, N) bf16 as wg_bf16_kernel
    cuts them, each token range's product in fp32 and the ranges added in
    order (wg_sum_kernel). The bias sums: of bmat itself where `sums` is
    None (a block's share of a range's chunks, chunk j to m-tile j mod
    m-tiles, lane r of a column group's eight summing the chunk's tokens r,
    r + 8, .. in order, the lanes added by wg_bf16_kernel's xor tree), else
    of `sums` (T, N) fp32 times `row_scale` (T) where given,
    wg_colsum_kernel's rows of WG_SUM_TOKENS tokens (64 a warp, the warps in
    order)."""
    t, m, n = a.shape[0], a.shape[1], bmat.shape[1]
    plan = tfb.weight_grad_bf16_plan(t, m, n)
    af, bf = a.float(), bmat.float()
    dw = torch.zeros(m, n)
    for z in range(plan["z"]):
        lo, hi = z * plan["chunk"], min(t, (z + 1) * plan["chunk"])
        dw = dw + af[lo:hi].T @ bf[lo:hi]
    rows = []
    if sums is None:
        for z in range(plan["z"]):
            lo, hi = z * plan["chunk"], min(t, (z + 1) * plan["chunk"])
            for mi in range(plan["nm"]):
                lanes = torch.zeros(8, n)
                for j in range(-(-(hi - lo) // tfb.WG_K)):
                    if j % plan["nm"] != mi:
                        continue
                    chunk = torch.zeros(tfb.WG_K, n)
                    c0 = lo + j * tfb.WG_K
                    chunk[: min(hi, c0 + tfb.WG_K) - c0] = bf[c0:min(hi, c0 + tfb.WG_K)]
                    for k0 in range(0, tfb.WG_K, 8):
                        lanes = lanes + chunk[k0:k0 + 8]
                for o in (1, 2, 4):  # the xor tree over the eight lanes
                    lanes = lanes + lanes[[r ^ o for r in range(8)]]
                rows.append(lanes[0])
    else:
        src = sums.float() * (1.0 if row_scale is None else row_scale.float()[:, None])
        wt = tfb.WG_SUM_TOKENS // 8
        for s0 in range(0, t, tfb.WG_SUM_TOKENS):
            warps = [src[w0:min(t, w0 + wt)].sum(0) if w0 < t else torch.zeros(n)
                     for w0 in range(s0, s0 + tfb.WG_SUM_TOKENS, wt)]
            row = warps[0]
            for w in warps[1:]:
                row = row + w
            rows.append(row)
    db = torch.zeros(n)
    for r in rows:
        db = db + r
    return dw, db


def _jax_dbias(p, shift):
    def f(bias):
        xr = jnp.roll(jnp.asarray(p["x"]), (-shift, -shift), axis=(1, 2))
        z = jfb.fused_attn_block(xr, *(jnp.asarray(p[k]) for k in ("g", "be", "wq", "bq", "wp",
                                                                   "bp")),
                                 bias, jnp.asarray(S), NH, HD, WS, 1e-5, True)
        return jnp.roll(z, (shift, shift), axis=(1, 2))

    _, vjp = jax.vjp(f, jnp.asarray(p["bias"]))
    return np.asarray(vjp(jnp.asarray(p["dout"]))[0])


def _window_ds(p, kinds, shift):
    """dS (B, nwh, nww, nh, n, n) of every window and head, in fp32, as the
    recompute backward builds it: y = LN(x), qkv, P from q k^T scale + the
    kind's table, datt = (s dout) wp^T, dP = datt v^T, dS = P (dP - rowsum(P
    dP)), on the map rolled by (-shift, -shift)."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    x, dout = tfb._roll(t["x"], -shift), tfb._roll(t["dout"], -shift)
    xn, _ = tfb._ln_parts(x.reshape(-1, C), 1e-5)
    qkv = (xn * t["g"] + t["be"]) @ t["wq"] + t["bq"]
    q, k, v = (tfb._heads(u, NH) for u in
               tfb._to_windows(qkv.reshape(B, HH, WW, 3 * C), WS).chunk(3, dim=-1))
    nwh, nww = HH // WS, WW // WS
    kind = tfb.window_kinds(nwh, nww, kinds)
    table = t["bias"][kind].reshape(nwh, nww, NH, N, N)
    prob = torch.softmax(q @ k.transpose(-1, -2) * HD**-0.5 + table, dim=-1)
    datt = (dout.reshape(-1, C) * float(S[0])) @ t["wp"].T
    da = tfb._heads(tfb._to_windows(datt.reshape(B, HH, WW, C), WS), NH)
    dprob = da @ v.transpose(-1, -2)
    return prob * (dprob - (dprob * prob).sum(-1, keepdim=True))


@pytest.mark.parametrize("kinds", [1, 4])
def test_grouped_dbias_matches_jax(kinds):
    """#6's bf16 window attention sums dbias by groups of one kind's windows
    in the kernel's order; the sums match the JAX kernel's dbias."""
    shift = WS // 2 if kinds == 4 else 0
    p = _params(np.random.default_rng(20 + kinds), kinds)
    groups = tfb.attn_dbias_groups(B, HH // WS, WW // WS, kinds)
    sizes = [(kind, len(w)) for kind, w in groups]
    assert sizes == ([(0, 8), (0, 8), (0, 4)] if kinds == 1
                     else [(0, 8), (0, 4), (1, 3), (2, 4), (3, 1)])
    for kind, wins in groups:  # every window of a group is of its kind
        for _, wi, wj in wins:
            assert kinds == 1 or kind == 2 * (wi == HH // WS - 1) + (wj == WW // WS - 1)
    got = _dbias_grouped(_window_ds(p, kinds, shift), kinds).numpy()
    want = _jax_dbias(p, shift)
    assert got.shape == want.shape == (kinds, NH, N, N)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * top, f"{np.abs(got - want).max():.3g} of {top:.3g}"


@pytest.mark.parametrize(("m", "n"), [(360, 180), (180, 540), (240, 240), (240, 720)])
def test_weight_grad_blocks_match_float64(m, n):
    """The weight-gradient stage's partition of the tokens (ranges of a
    multiple of 64 tokens, the last ragged), its partial products and the
    partial rows of both kinds of bias sums, added in order, within 1e-5 of
    float64."""
    t = 1000
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(rng.standard_normal((t, m)).astype(np.float32)).bfloat16()
    src = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    b = src.bfloat16()
    scale = torch.from_numpy(np.repeat(np.asarray([1.0, 0.8], np.float32), [400, 600]))
    plan = tfb.weight_grad_bf16_plan(t, m, n)
    assert plan["chunk"] % tfb.WG_K == 0 and plan["z"] > 1 and t % plan["chunk"]
    exact_w = a.double().T @ b.double()
    for sums, row_scale, exact_b in ((None, None, b.double().sum(0)),
                                     (src, scale, (src.double() * scale.double()[:, None]).sum(0))):
        dw, db = _wg_blocked(a, b, sums, row_scale)
        for got, exact in ((dw, exact_w), (db, exact_b)):
            top = exact.abs().max().item()
            assert (got.double() - exact).abs().max().item() <= 1e-5 * top


def _constexpr(text, name):
    """The value of `constexpr int name = ...;` in a source, its operands
    other constants of the same source."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return eval(re.sub(r"\bk[A-Z]\w*", lambda mt: str(_constexpr(text, mt.group(0))), expr))


def _wg_unit(cols, base):
    """wgrad_bf16.cuh's copy unit (bytes) of an operand of `cols` columns."""
    return 16 if cols % 8 == 0 and base % 16 == 0 else 8


def _group_unit(c, nh, base):
    """attn_group_bf16.cuh's copy unit (elements): 16, 8 or 4 bytes, else 0."""
    hd = c // nh
    return next((u for u in (8, 4, 2) if hd % u == 0 and c % u == 0 and base % (2 * u) == 0), 0)


def test_plans_match_the_sources():
    """The mirrors of the two kernels' plans hold the sources' constants
    and rules: chunks of 64 tokens on four stages, 128-row tiles of one of
    64-256 columns, one wave of 132 blocks, bias-sum rows of 512 tokens;
    groups of 8 windows, 288 threads, the rooms' strides; shared memory
    within one thread block's 232,448 bytes at every caller's width; the
    copy units."""
    wg = (CSRC / "wgrad_bf16.cuh").read_text()
    grp = (CSRC / "attn_group_bf16.cuh").read_text()
    assert (tfb.WG_K, tfb.WG_STAGES, tfb.WG_ROWS, tfb.WG_WAVE_BLOCKS, tfb.WG_SUM_TOKENS) == tuple(
        _constexpr(wg, k) for k in ("kWgK", "kWgStages", "kWgRows", "kWgWaveBlocks",
                                    "kWgSumTokens"))
    assert (tfb.GROUP_N, tfb.GROUP_WINDOWS, tfb.GROUP_THREADS, tfb.GROUP_LD, tfb.GROUP_LP) == tuple(
        _constexpr(grp, k) for k in ("kGroupN", "kGroupWindows", "kGroupThreads", "kGroupLd",
                                     "kGroupLp"))
    assert "for (int bn = 192; bn >= 64; bn -= 64)" in wg and "(kWgRows + bn)" in wg
    assert [tfb.weight_grad_bf16_cols(n) for n in (60, 120, 180, 240, 276, 308, 360, 480, 540,
                                                   616, 720)] == [
        64, 128, 192, 256, 192, 192, 192, 256, 192, 256, 256]
    # a stage: a (64, 128) A tile and a (64, BN) B tile in bf16, two mbarriers
    for n, bn in ((180, 192), (240, 256), (60, 64), (120, 128)):
        assert tfb.weight_grad_bf16_smem_bytes(n) == 4 * (64 * (128 + bn) * 2 + 16)
    assert tfb.weight_grad_bf16_smem_bytes(240) == 196_672 <= SMEM_LIMIT
    plan = tfb.weight_grad_bf16_plan(82_944, 240, 720)  # #6's dwq at SRFormerV2's block
    assert plan == {"bn": 256, "nm": 2, "nn": 3, "chunk": 3776, "z": 22}
    assert plan["nm"] * plan["nn"] * plan["z"] <= tfb.WG_WAVE_BLOCKS
    assert tfb.weight_grad_bf16_part_floats(82_944, 240, 720) == 22 * 240 * 720 + 162 * 720
    assert tfb.attn_group_smem_bytes() == 218_880 <= SMEM_LIMIT
    assert tfb.attn_block_bf16_smem_bytes(240) == tfb.attn_group_smem_bytes()
    assert len(tfb.attn_dbias_groups(16, 6, 6, 4)) == 50 + 10 + 10 + 2  # SRFormerV2's block
    # the copy units: the rules of the sources, at the callers' widths
    assert "M % 8 == 0 && a % 16 == 0 ? 16 : 8" in wg and "N % 8 == 0 && b % 16 == 0 ? 16 : 8" in wg
    assert [_wg_unit(c, 0) for c in (180, 240, 276, 308, 540, 720)] == [8, 16, 8, 8, 8, 16]
    assert "for (int u = 8; u >= 2; u /= 2)" in grp
    assert "hd % u == 0 && C % u == 0 && base % (2 * u) == 0" in grp
    assert [_group_unit(c, nh, 0) for c, nh in ((240, 8), (256, 8), (180, 6), (60, 4))] == [
        2, 8, 2, 0]
