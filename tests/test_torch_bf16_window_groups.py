"""The grouped bf16 window attention (csrc/attn_group_bf16.cuh) on the CPU,
where its kernels do not run: models of the order in which the kernels sum,
held against the JAX package's Pallas kernels in interpret mode, and the
Python mirrors of their plans held against the sources.

- #8's backward as the kernels cut it (`_grouped_bwd`): each kind's windows
  in groups (`tfb.attn_dbias_groups` with `windows` a group), a row pass a
  block of 64 rows at n 256 (the whole window below) summing the groups' dS
  in window order, writing dQ and each row's (max, inverse sum, rowsum(P
  dP)); a key pass recomputing P from those stats and dS from dP - rowsum(P
  dP) for dV and dK; the groups' sums added by kind in order. Against
  `jax.vjp` of the JAX `fused_window_mhsa` / `fused_rect_mhsa` at 16x16
  windows (K=1, and K=4 with the masks of a shift by 8), at 8x32 (K=4) and
  at 8x8 (K=4), on maps whose kinds hold window counts that are no multiple
  of the group (16x16 on 48x48: 9 windows, groups of 4 at K=1 and 3 at K=4;
  8x32 on 32x64: 3, 3, 1, 1 windows, groups of 2; 8x8 on two 24x40: 16, 4,
  8, 2 windows, groups of 3): in fp32 within 1e-4 of each of dq's, dk's,
  dv's and dbias's largest magnitude; in bf16 (the kernels' roundings: bf16
  P in dV, bf16(scale dS) in dQ and dK, dq, dk, dv rounded) within 1.5e-2
  of each, the bf16 limit of PERF.md section 2.
- #1's window attention as its kernel walks it (`_grouped_attn_fwd`): the
  groups of a kind's windows at the plan's group size, bf16(P / sum) v per
  window, then the plain proj and residual, against the JAX
  `fused_attn_block` on a bf16 x at 12x12 windows (K=1, K=4 shifted by 6):
  z within 2^-6 of its largest magnitude, at most one element in a
  thousand beyond 2^-8 of it (tests/test_torch_bf16_srformerv2.py's
  limits).
- The mirrors of the plans (shared memory, blocks a SM, group sizes,
  grids, scratch and stats shapes) against the constants and rules that
  the sources are built from.

2 heads of 16 channels; each JAX shape is traced once.
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
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import fused_block as tfb
from trainner_redux_tpu_torch.ops import window_attention as twa

NH, HD = 2, 16
C = NH * HD
FP32_TOL = 1e-4  # of each tensor's largest magnitude
GRAD_TOL = 1.5e-2  # bf16: of each gradient tensor's largest magnitude
OUT_TOL, OUT_FAR, OUT_FAR_SHARE = 2.0**-6, 2.0**-8, 1e-3
CSRC = Path(twa.__file__).resolve().parents[1] / "csrc"

# (window, K, (B, H, W), windows a group of the model's grids)
CASES = [((16, 16), 1, (1, 48, 48), 4), ((16, 16), 4, (1, 48, 48), 3),
         ((8, 32), 4, (1, 32, 64), 2), ((8, 8), 4, (2, 24, 40), 3)]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(window, kinds, shape):
    wr, wc = window
    rng = np.random.default_rng(wr * 100 + wc + kinds)
    qkv = _bf16(rng.standard_normal((*shape, 3 * C)).astype(np.float32))
    rel = (rng.standard_normal((NH, wr * wc, wr * wc)) * 0.3).astype(np.float32)
    masks = jwa.rect_shift_mask_kinds(wr, wc, wr // 2, wc // 2)[:, None] if kinds == 4 else 0.0
    bias = np.ascontiguousarray(rel[None] + masks, dtype=np.float32)
    dout = _bf16(rng.standard_normal((*shape, C)).astype(np.float32))
    return qkv, bias, dout


def _windows(t, wr, wc):
    """(B, H, W, nh hd) -> (B, nwh, nww, nh, n, hd) in fp32."""
    b, hh, ww, c = t.shape
    x = t.float().reshape(b, hh // wr, wr, ww // wc, wc, NH, c // NH)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, hh // wr, ww // wc, NH, wr * wc, c // NH)


def _unwindows(x, wr, wc):
    """The inverse of `_windows`."""
    b, nwh, nww, nh, _, hd = x.shape
    x = x.reshape(b, nwh, nww, nh, wr, wc, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, nwh * wr, nww * wc, nh * hd)


def _grouped_bwd(qkv, bias, dout, wr, wc, gw, bf16):
    """#8's (dqkv, dbias) in the grouped kernels' order (module doc): `gw`
    windows a group, fp32 sums; `bf16`: the kernels' roundings."""
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    b, hh, ww, _ = qkv.shape
    n, nwh, nww, kinds = wr * wc, hh // wr, ww // wc, bias.shape[0]
    q, k, v = (_windows(t, wr, wc) for t in qkv.chunk(3, dim=-1))
    da = _windows(dout, wr, wc)
    scale = HD**-0.5
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    rb = twa.PASS_ROWS if n == twa.PASS_N else n
    stats = torch.zeros(b, nwh, nww, NH, n, 3)
    groups = tfb.attn_dbias_groups(b, nwh, nww, kinds, gw)
    parts = []
    for kind, wins in groups:  # the row pass: each block of rows over the group
        part = torch.zeros(NH, n, n)
        for r0 in range(0, n, rb):
            rows = slice(r0, r0 + rb)
            for bi, wi, wj in wins:
                qw, kw, vw, aw = (t[bi, wi, wj] for t in (q, k, v, da))
                s = qw[:, rows] @ kw.transpose(-1, -2) * scale + bias[kind][:, rows]
                mx = s.amax(-1, keepdim=True)
                e = torch.exp(s - mx)
                inv = 1.0 / e.sum(-1, keepdim=True)
                p = e * inv
                dp = aw[:, rows] @ vw.transpose(-1, -2)
                delta = (p * dp).sum(-1, keepdim=True)
                ds = p * (dp - delta)
                part[:, rows] = part[:, rows] + ds
                dq[bi, wi, wj, :, rows] = rnd(rnd(scale * ds) @ kw)
                stats[bi, wi, wj, :, rows] = torch.cat([mx, inv, delta], dim=-1)
        parts.append((kind, part))
    for bi in range(b):  # the key pass: P and dS again from the stats
        for wi in range(nwh):
            for wj in range(nww):
                kind = twa.window_kinds(nwh, nww, kinds)[wi * nww + wj]
                qw, kw, vw, aw = (t[bi, wi, wj] for t in (q, k, v, da))
                mx, inv, delta = stats[bi, wi, wj].unbind(-1)
                s = qw @ kw.transpose(-1, -2) * scale + bias[kind]
                p = torch.exp(s - mx[..., None]) * inv[..., None]
                ds = p * (aw @ vw.transpose(-1, -2) - delta[..., None])
                dv[bi, wi, wj] = rnd(rnd(p).transpose(-1, -2) @ aw)
                dk[bi, wi, wj] = rnd(rnd(scale * ds).transpose(-1, -2) @ qw)
    dbias = torch.zeros(kinds, NH, n, n)
    for kind, part in parts:  # the groups' sums by kind, in order
        dbias[kind] = dbias[kind] + part
    return torch.cat([_unwindows(t, wr, wc) for t in (dq, dk, dv)], dim=-1), dbias


def _jax_bwd(qkv, bias, dout, wr, wc, dtype):
    def f(q, b):
        if wr == wc:
            return jwa.fused_window_mhsa(q, b, NH, HD, wr, True)
        return jwa.fused_rect_mhsa(q, b, NH, HD, wr, wc, True)

    _, vjp = jax.vjp(f, jnp.asarray(qkv, dtype), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(dout, dtype))
    return np.asarray(dqkv, np.float32), np.asarray(dbias, np.float32)


def _assert_parts_close(got, want, tol):
    """dq, dk, dv (the channel thirds of dqkv) and dbias, each within tol of
    its largest magnitude."""
    named = list(zip(("dq", "dk", "dv"), np.split(got[0], 3, axis=-1),
                     np.split(want[0], 3, axis=-1))) + [("dbias", got[1], want[1])]
    for name, g, w in named:
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= tol * top, f"{name}: max|diff| {err:.3g} vs max {top:.3g}"


@pytest.mark.parametrize(("window", "kinds", "shape", "gw"), CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_grouped_window_backward_matches_jax(window, kinds, shape, gw):
    """#8's grouped order against jax.vjp of the JAX kernel, fp32 and bf16
    (module doc), on maps whose kinds' windows are no multiple of a group."""
    wr, wc = window
    b, hh, ww = shape
    counts = [len(twa.kind_windows(b, hh // wr, ww // wc, kinds, k)) for k in range(kinds)]
    assert any(cnt % gw for cnt in counts), counts
    qkv, bias, dout = _inputs(window, kinds, shape)
    tq, tb, td = (torch.from_numpy(a) for a in (qkv, bias, dout))
    got = _grouped_bwd(tq, tb, td, wr, wc, gw, bf16=False)
    want = _jax_bwd(qkv, bias, dout, wr, wc, jnp.float32)
    _assert_parts_close([t.numpy() for t in got], want, FP32_TOL)
    got = _grouped_bwd(tq, tb, td, wr, wc, gw, bf16=True)
    want = _jax_bwd(qkv, bias, dout, wr, wc, jnp.bfloat16)
    _assert_parts_close([t.numpy() for t in got], want, GRAD_TOL)


def _grouped_attn_fwd(p, s, shift, ws=12, eps=1e-5):
    """#1's bf16 z with its window attention walked as the kernel walks it:
    the groups of each kind's windows (the plan's group size at this map),
    each window's bf16(bf16(P / sum) v), then the plain proj and residual
    (tfb._attn_half_bf16_rows' roundings)."""
    x = torch.from_numpy(p["x"])
    b, hh, ww, c = x.shape
    t = tfb._roll(x, -shift).reshape(-1, c)
    prm = {k: torch.from_numpy(p[k]) for k in ("g", "be", "wq", "bq", "wp", "bp", "bias")}
    _, (q, k, v) = tfb._qkv_bf16_rows(t, prm["g"], prm["be"], prm["wq"], prm["bq"], b, hh, ww,
                                      NH, ws, eps)
    nwh, nww, kinds = hh // ws, ww // ws, prm["bias"].shape[0]
    q, k, v = (u.reshape(b, nwh, nww, NH, ws * ws, HD) for u in (q, k, v))
    gw = twa.group_windows(b, nwh, nww, kinds, NH, tfb.GROUP_FWD_BLOCKS)
    att = torch.zeros_like(q)
    for kind, wins in tfb.attn_dbias_groups(b, nwh, nww, kinds, gw):
        for bi, wi, wj in wins:
            sc = q[bi, wi, wj] @ k[bi, wi, wj].transpose(-1, -2) * HD**-0.5 + prm["bias"][kind]
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            att[bi, wi, wj] = tfb._bf(tfb._bf(e / e.sum(-1, keepdim=True)) @ v[bi, wi, wj])
    att = tfb._from_windows(tfb._merge_heads(att), ws).reshape(-1, c)
    srow = tfb._row_scale(torch.from_numpy(s), b, hh * ww)
    z = tfb._bf(t + tfb._bf(tfb._bf(srow) * tfb._bf(tfb._bf(att @ tfb._bf(prm["wp"]))
                                                     + tfb._bf(prm["bp"]))))
    return tfb._roll(z.reshape(b, hh, ww, c), shift)


@pytest.mark.parametrize("kinds", [1, 4])
def test_grouped_attn_forward_matches_jax(kinds):
    """#1's grouped window attention against the JAX fused_attn_block on a
    bf16 x at 12x12 windows, K=1 and K=4 shifted by 6 (B 1, 36x24: 6
    windows)."""
    ws, shift = 12, 6 if kinds == 4 else 0
    b, hh, ww = 1, 36, 24
    rng = np.random.default_rng(60 + kinds)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    masks = jwa.rect_shift_mask_kinds(ws, ws, ws // 2, ws // 2)[:, None] if kinds == 4 else 0.0
    p = {"x": _bf16(normal(b, hh, ww, C)), "g": 1.0 + normal(C, scale=0.1),
         "be": normal(C, scale=0.1), "wq": normal(C, 3 * C, scale=C**-0.5),
         "bq": normal(3 * C, scale=0.1), "wp": normal(C, C, scale=C**-0.5),
         "bp": normal(C, scale=0.1),
         "bias": np.ascontiguousarray(normal(NH, ws * ws, ws * ws, scale=0.3)[None] + masks,
                                      dtype=np.float32)}
    s = np.asarray([0.8], np.float32)
    xr = jnp.roll(jnp.asarray(p["x"], jnp.bfloat16), (-shift, -shift), axis=(1, 2))
    want = jfb.fused_attn_block(xr, *(jnp.asarray(p[k]) for k in ("g", "be", "wq", "bq", "wp",
                                                                  "bp", "bias")),
                                jnp.asarray(s), NH, HD, ws, 1e-5, True)
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)), np.float32)
    got = _grouped_attn_fwd(p, s, shift).numpy()
    top, err = np.abs(want).max(), np.abs(got - want)
    assert err.max() <= OUT_TOL * top, f"z: max|diff| {err.max():.3g} vs max {top:.3g}"
    assert float((err > OUT_FAR * top).mean()) <= OUT_FAR_SHARE


def _constexpr(text, name):
    """The value of `constexpr int name = ...;` in a source, its operands
    other constants of the same source."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return eval(re.sub(r"\bk[A-Z]\w*", lambda mt: str(_constexpr(text, mt.group(0))), expr))


def test_plans_match_the_sources():
    """The Python mirrors of the grouped kernels' plans hold the source's
    constants and rules: groups of at most 8 windows filling two waves of
    132 SMs, the n-256 passes' blocks of 64 rows or keys on 8 and 4 warps
    (one and two blocks a SM), #1's one; the rooms' stride; each kernel's shared
    memory within one block's 232,448 bytes and its blocks within a SM's
    233,472; the groups, grids and scratch at the main paths' blocks."""
    src = (CSRC / "attn_group_bf16.cuh").read_text()
    assert (twa.GROUP_MAX_WINDOWS, twa.GROUP_SMS, twa.GROUP_LD, twa.PASS_N, twa.PASS_ROWS,
            twa.PASS_THREADS, twa.ROW_PASS_THREADS, twa.ROW_PASS_BLOCKS, twa.KEY_PASS_BLOCKS,
            tfb.GROUP_FWD_BLOCKS) == tuple(
        _constexpr(src, k) for k in ("kGroupWindows", "kGroupSms", "kGroupLd", "kPassN",
                                     "kPassRows", "kPassThreads", "kRowPassThreads",
                                     "kRowPassBlocks", "kKeyPassBlocks", "kGroupFwdBlocks"))
    assert "group_blocks(int n) { return n == 64 ? 3 : 1; }" in src
    assert twa.GROUP_BWD_BLOCKS == {64: 3, 128: 1, 144: 1}
    assert "return n / 16 * 32;" in src and "return n + 8;" in src
    # the windows of the stated shape rule, in the source's terms
    rule = re.search(r"bool window_bwd_grouped\(int wr, int wc\) \{\s*return ([^;]+);", src)
    for wr in (4, 8, 16, 32, 64):
        for wc in (4, 8, 16, 32, 64):
            expr = rule.group(1).replace("&&", " and ").replace("||", " or ")
            assert eval(f"({expr})") == (
                twa.window_bwd_grouped(30, wr, wc)), (wr, wc)
    assert not twa.window_bwd_grouped(35, 16, 16)
    # shared memory, from the source's formulas
    assert "4 * n * n + 2 * 2 * 4 * n * kGroupLd + 2 * n * group_lp(n)" in src
    assert "return attn_group_smem_bytes(n) + 4 * n;" in src
    assert "4 * kPassRows * kPassN + 2 * 2 * (2 * kPassRows + 2 * kPassN) * kGroupLd +" in src
    assert "4 * (3 * 2 * kPassRows + 32 * kPassRows) + 2 * kPassRows + 2 * kPassN" in src
    assert "2 * 2 * (2 * kPassN + 2 * kPassRows) * kGroupLd + 2 * 16 * kPassN + 2 * kPassN" in src
    assert "2 * 2 * 3 * kGroupN * kGroupLd + 3 * kGroupN" in src
    plans = {"n 64": (twa.window_bwd_smem_bytes(64), 3),
             "n 128": (twa.window_bwd_smem_bytes(128), 1), "n 144": (tfb.attn_group_smem_bytes(), 1),
             "row pass": (twa.rows_pass_smem_bytes(), twa.ROW_PASS_BLOCKS),
             "key pass": (twa.keys_pass_smem_bytes(), twa.KEY_PASS_BLOCKS),
             "#1": (tfb.attn_group_fwd_smem_bytes(), tfb.GROUP_FWD_BLOCKS)}
    assert {k: v[0] for k, v in plans.items()} == {
        "n 64": 66_816, "n 128": 182_784, "n 144": 218_880, "row pass": 178_304,
        "key pass": 111_232, "#1": 69_552}
    for name, (smem, blocks) in plans.items():
        assert smem <= twa.SMEM_LIMIT and blocks * (smem + 1024) <= 233_472, name
    # the groups and grids of the header comment, K=4
    hat = (8, 48, 48, 6, 4, 16, 16)
    assert [twa.window_bwd_group_windows(*hat, p) for p in (0, 1)] == [7, 3]
    assert twa.group_offsets(8, 3, 3, 4, 7)[4] == 13 and twa.group_offsets(8, 3, 3, 4, 3)[4] == 26
    dat = (8, 64, 64, 3, 4, 8, 32)
    assert [twa.window_bwd_group_windows(*dat, p) for p in (0, 1)] == [6, 3]
    assert twa.group_offsets(8, 8, 2, 4, 6)[4] == 24 and twa.group_offsets(8, 8, 2, 4, 3)[4] == 44
    assert twa.window_bwd_group_windows(8, 48, 48, 8, 4, 8, 8) == 2
    assert twa.group_offsets(8, 6, 6, 4, 2)[4] == 144
    assert twa.group_windows(16, 6, 6, 4, 8, tfb.GROUP_FWD_BLOCKS) == 8
    assert twa.group_offsets(16, 6, 6, 4, 8) == [0, 50, 60, 70, 72]
    # scratch: the groups' sums (groups, nh, n, n) and the row stats (B,
    # nwh, nww, nh, n, 4) at n 256 only
    assert twa.window_bwd_scratch_floats(*hat) == (13 * 6 * 256 * 256, 8 * 9 * 6 * 256 * 4)
    assert twa.window_bwd_scratch_floats(8, 48, 48, 8, 4, 8, 8) == (144 * 8 * 64 * 64, 0)
    # each model's groups are the plan's (kinds in order, `windows` a group)
    groups = tfb.attn_dbias_groups(8, 3, 3, 4, 7)
    assert len(groups) == 13 and [len(w) for _, w in groups][:6] == [7, 7, 7, 7, 4, 7]
