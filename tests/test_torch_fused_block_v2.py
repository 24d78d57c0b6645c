"""Torch port's post-norm SwinV2 block halves (TPU kernels #11-#14) vs the
JAX package's Pallas kernels (interpret mode), on the CPU, where the port's
wrappers run their plain versions.

Same inputs from a numpy seed through both: B=2, 16x24, C=24 (3 heads of
8), hidden 48, window 8, DropPath scales s = [0, 1/0.9], temperatures
between 1 and 100, a bias table of 16 * sigmoid values (plus the shift
masks at K=4). The forward within 1e-5, each gradient (the port's plain
backward, and its autograd Function on the CPU, against `jax.vjp` of the
JAX kernel) within 1e-4 of the tensor's largest magnitude. K=4 runs both
the JAX contract (the caller rolls) and the port's shift argument.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block_v2 as jv2
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block_v2 as tv2

B, HH, WW, NH, HD, WS, HIDDEN = 2, 16, 24, 3, 8, 8, 48
C, N = NH * HD, WS * WS
S = np.asarray([0.0, 1.0 / 0.9], np.float32)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude
COS = ("x", "wq", "bq", "scale", "wp", "bp", "g", "be", "bias")
COS_GRADS = ("dx", "dwq", "dbq", "dscale", "dwp", "dbp", "dg", "dbe", "dbias")
MLP = ("x", "w1", "b1", "w2", "b2", "g", "be")
MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")


def _params(rng, kinds=1):
    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bias = 16.0 / (1.0 + np.exp(-normal(NH, N, N)))
    bias = bias[None] + (shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0)
    return {
        "x": normal(B, HH, WW, C),
        "wq": normal(C, 3 * C, scale=0.2), "bq": normal(3 * C, scale=0.1),
        "scale": np.exp(rng.uniform(0.0, np.log(100.0), NH)).astype(np.float32),
        "wp": normal(C, C, scale=0.2), "bp": normal(C, scale=0.1),
        "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(bias, dtype=np.float32),
        "w1": normal(C, HIDDEN, scale=0.2), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=0.2), "b2": normal(C, scale=0.1),
        "dout": normal(B, HH, WW, C),
    }


def _jax_cos(shift):
    """The JAX kernel under its contract: the caller rolls x and z."""
    def fn(x, *rest):
        if shift:
            x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        z = jv2.fused_cos_attn_block(x, *rest, jnp.asarray(S), NH, HD, WS, 1e-5, True)
        return jnp.roll(z, (shift, shift), axis=(1, 2)) if shift else z
    return fn


def _close_grads(names, got, want):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


@pytest.mark.parametrize(("kinds", "shift"), [(1, 0), (4, 0), (4, WS // 2)])
def test_fused_cos_attn_block_matches_jax(kinds, shift):
    p = _params(np.random.default_rng(10 + kinds + shift), kinds)
    ops = [p[k] for k in COS]
    want, vjp = jax.vjp(_jax_cos(shift), *map(jnp.asarray, ops))
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(p["dout"]))]
    t_ops, s, dout = [torch.from_numpy(a) for a in ops], torch.from_numpy(S), torch.from_numpy(
        p["dout"])

    launches = (tv2.fused_cos_attn_block.launches, tv2.fused_cos_attn_block_backward.launches)
    got = tv2.fused_cos_attn_block(*t_ops, s, NH, HD, WS, 1e-5, shift=shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    direct = tv2.fused_cos_attn_block_backward(*t_ops, s, dout, NH, HD, WS, 1e-5, shift)
    leaves = [t.clone().requires_grad_() for t in t_ops]
    tv2.fused_cos_attn_block(*leaves, s, NH, HD, WS, 1e-5, shift=shift).backward(dout)
    # CPU: the plain versions, no kernel launched
    assert (tv2.fused_cos_attn_block.launches,
            tv2.fused_cos_attn_block_backward.launches) == launches
    _close_grads(COS_GRADS, direct, want_g)
    _close_grads(COS_GRADS, [t.grad for t in leaves], want_g)


@pytest.mark.parametrize("scales", [[0.0, 1.0 / 0.9], [1.0, 1.0]])
def test_fused_postnorm_mlp_matches_jax(scales):
    p = _params(np.random.default_rng(20))
    s_np = np.asarray(scales, np.float32)
    ops = [p[k] for k in MLP]
    want, vjp = jax.vjp(lambda *a: jv2.fused_postnorm_mlp(*a, jnp.asarray(s_np), WS, 1e-5, True),
                        *map(jnp.asarray, ops))
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(p["dout"]))]
    t_ops, s, dout = [torch.from_numpy(a) for a in ops], torch.from_numpy(s_np), torch.from_numpy(
        p["dout"])

    launches = (tv2.fused_postnorm_mlp.launches, tv2.fused_postnorm_mlp_backward.launches)
    got = tv2.fused_postnorm_mlp(*t_ops, s, WS, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    direct = tv2.fused_postnorm_mlp_backward(*t_ops, s, dout, WS, 1e-5)
    leaves = [t.clone().requires_grad_() for t in t_ops]
    tv2.fused_postnorm_mlp(*leaves, s, WS, 1e-5).backward(dout)
    assert (tv2.fused_postnorm_mlp.launches, tv2.fused_postnorm_mlp_backward.launches) == launches
    _close_grads(MLP_GRADS, direct, want_g)
    _close_grads(MLP_GRADS, [t.grad for t in leaves], want_g)


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_autograd_functions_match_plain_autograd(half):
    """The autograd Functions on the CPU (the plain backward) against torch
    autograd through the plain forward, the same chain, within 1e-5 of each
    gradient's largest."""
    p = _params(np.random.default_rng(30), kinds=4)
    s, dout = torch.from_numpy(S), torch.from_numpy(p["dout"])
    if half == "attention":
        names, fn, plain = COS, tv2.fused_cos_attn_block, tv2.fused_cos_attn_block_reference
        meta = (NH, HD, WS, 1e-5, WS // 2)
    else:
        names, fn, plain = MLP, tv2.fused_postnorm_mlp, tv2.fused_postnorm_mlp_reference
        meta = (WS, 1e-5)
    grads = []
    for f in (fn, plain):
        leaves = [torch.from_numpy(p[k]).requires_grad_() for k in names]
        grads.append(torch.autograd.grad(f(*leaves, s, *meta), leaves, dout))
    for name, g, w in zip(names, *grads):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item(), name


def test_fused_block_v2_gate(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    gate = tv2.fused_block_v2_supported
    assert gate(48, 48, 8, 180, 6, 360, train=True)  # Swin2SR-M training
    assert gate(104, 120, 8, 180, 6, 360)  # Swin2SR-M serving, a padded image
    assert gate(64, 64, 8, 60, 6, 120, train=True)  # Swin2SR-S
    assert gate(64, 64, 8, 240, 8, 480)  # Swin2SR-L serves on the kernels...
    assert gate(64, 64, 8, 240, 8, 480, train=True)  # ...and trains on them (#14 on the engine)
    assert not gate(60, 64, 8, 180, 6, 360)  # not window-aligned
    assert not gate(64, 64, 16, 180, 6, 360)  # 16x16 windows
    assert not gate(64, 64, 8, 384, 6, 768)  # heads of 64 channels
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")  # the JAX tests' mode: still on
    assert gate(48, 48, 8, 180, 6, 360, train=True)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
    assert not gate(48, 48, 8, 180, 6, 360)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "1")
    monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    assert not gate(48, 48, 8, 180, 6, 360)
    monkeypatch.setenv("TRAINNER_FUSED_V2", "0")  # the JAX package's TPU opt-in is not read
    monkeypatch.delenv("TRAINNER_FUSED_ATTN")
    assert gate(48, 48, 8, 180, 6, 360)


def test_shared_memory_plans_at_swin2sr_m():
    """The plans the kernels carve (csrc/fused_block_v2.cu, csrc/tc_rows.cuh,
    csrc/tc_attn.cuh), fp32, at Swin2SR-M's C=180, 6 heads of 30, hidden
    360. The forwards (#11, #13) run in stages: qkv and hg on linear_kernel
    at 128-column tiles, proj and m at the 96-column tile of a 180-channel
    row, #11's cosine window attention per (8x8 window, head) (k and v of
    the window, q and att of its 64 rows, 36 floats apart, the (64, 68) P
    tile, the key halves' row max and sum, the token indices), and a row
    pass for the post-norm that takes no shared memory. #12's per-window
    backward on the tensor cores (q, k, v, datt rows of 36 floats, the (64,
    68) P / dS tile, the exchanges, norms, warp sums and token indices) and
    its per-token stages on the engine (datt and dx over a 192-column row);
    #14's stages on the same engine (hg and m at those tiles, h and dh per
    128 hidden units, dx over the row)."""
    col96 = 4 * (6 * 96 * 16 + 4 * (128 * 20 + 96 * 20) + 16)
    assert tv2.linear_smem_bytes() == 131_136
    assert tv2.residual_smem_bytes(180) == col96 == 108_608
    attn = 4 * (2 * 64 * 36 + 2 * 64 * 36 + 64 * 68 + 2 * 2 * 64 + 64)
    assert tv2.attn_fwd_tc_smem_bytes(64) == attn == 55_552
    assert tv2.pn_mlp_fwd_smem_bytes(180) == max(131_136, col96) == 131_136
    assert tv2.cos_attn_fwd_smem_bytes(180) == max(131_136, col96, attn) == 131_136
    assert tv2.cos_attn_bwd_smem_bytes() == 4 * (4 * 64 * 36 + 64 * 68 + 6 * 64 + 128 + 8 + 64)
    assert tv2.rows_smem_bytes(180) == 4 * (6 * 192 * 16 + 4 * (128 * 20 + 192 * 20) + 16)
    assert tv2.pn_mlp_bwd_smem_bytes(180, 360) == max(
        tv2.linear_smem_bytes(), tv2.mlp_hidden_smem_bytes(), tv2.rows_smem_bytes(180))
    assert tv2.pn_mlp_bwd_smem_bytes(180, 360) == 4 * (128 * 128 + 6 * 128 * 16
                                                       + 4 * 2 * 128 * 20 + 16)
    # no forward plan depends on the heads or the hidden width, and none
    # grows past a 128-column product's
    assert {tv2.cos_attn_fwd_smem_bytes(c) for c in (16, 60, 90, 180, 240, 768)} == {131_136}
    assert max(tv2.pn_mlp_bwd_smem_bytes(180, 360), tv2.rows_smem_bytes(180)) <= tv2.SMEM_LIMIT
    # Swin2SR-L: dx spans a 256-column row
    assert tv2.pn_mlp_bwd_smem_bytes(240, 480) == tv2.rows_smem_bytes(240) == 221_248
    assert tv2.pn_mlp_bwd_smem_bytes(240, 480) <= tv2.SMEM_LIMIT
    # #12 trains rows the engine takes: at most 256 channels, multiples of 4
    assert tv2.cos_attn_fits(48, 48, 8, 180, 6, train=True)
    assert tv2.cos_attn_fits(48, 48, 8, 240, 8, train=True)
    assert not tv2.cos_attn_fits(48, 48, 8, 90, 3, train=True)
    assert tv2.cos_attn_fits(48, 48, 8, 90, 3)  # the forward alone takes them


def _fma_forward_took(half, c, n):
    """Whether the fp32 FMA forwards that the stages replaced took a shape:
    #11 (n heads) kept x and the attention output as transposed (C, 68)
    tiles, one head's q^ and k^ (hd, 68), v (64, 32), the score tile, a 2 x
    32 x 96 weight stage and the 128 inverse norms, the proj rows in the x
    tile (C >= 16); #13 (n hidden units) x and the hidden layer as (C, 68)
    and (hidden, 68) tiles and the stage. Each within one block's shared
    memory."""
    stage = 2 * 32 * 96
    if half == "attention":
        if c < 16 or c % n or c // n > 32:
            return False
        hd = c // n
        floats = 2 * c * 68 + 2 * hd * 68 + 64 * 32 + 64 * 68 + stage + 128
    else:
        if c < 16:
            return False
        floats = c * 68 + n * 68 + stage
    return 4 * floats <= tv2.SMEM_LIMIT


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_forward_gates_take_every_shape_the_fma_forwards_took(half):
    """The staged forwards take at least what the FMA forwards took: every
    width (with every head count, every hidden width) that fit the old
    kernels' shared memory passes the new gate, Swin2SR-S/M/L's and C 90 /
    3 heads, (180, 362) and (264, 264) among them (rows not in 16-byte
    pieces, a row wider than one rows_kernel tile). The row pass takes rows
    of up to PN_MAX_C channels."""
    took = 0
    if half == "attention":
        named = [(60, 6), (180, 6), (240, 8), (90, 3)]
        grid = [(c, nh) for c in range(16, 800) for nh in range(1, 33) if c % nh == 0]
        fits = lambda c, nh: tv2.cos_attn_fits(48, 48, 8, c, nh)  # noqa: E731
    else:
        named = [(60, 120), (180, 360), (240, 480), (90, 180), (180, 362), (264, 264)]
        grid = [(c, hidden) for c in range(16, 800, 3) for hidden in range(1, 800, 7)]
        fits = lambda c, hidden: tv2.pn_mlp_fits(48, 8, c, hidden)  # noqa: E731
    for c, n in named:
        assert _fma_forward_took(half, c, n), (c, n)
    for c, n in named + grid:
        if _fma_forward_took(half, c, n):
            took += 1
            assert fits(c, n), (half, c, n)
    assert took > len(named)
    assert max(c for c, n in grid if _fma_forward_took(half, c, n)) <= tv2.PN_MAX_C


def test_postnorm_mlp_trains_the_rows_the_engine_takes():
    """#14's backward runs on the tensor-core engine, so its gate in training
    is the engine's: Swin2SR-M's and Swin2SR-L's rows (C 180 / hidden 360,
    C 240 / hidden 480) and Swin2SR-S's (60 / 120) train on the kernels;
    rows that are not 16-byte pieces (C 90, or a hidden of 362) or wider
    than one rows_kernel tile (C 264) do not, though the forward takes
    them."""
    fits = tv2.pn_mlp_fits
    for c, hidden in ((180, 360), (240, 480), (60, 120), (256, 256)):
        assert fits(48, 8, c, hidden, train=True), (c, hidden)
    for c, hidden in ((90, 180), (180, 362), (264, 264)):
        assert fits(48, 8, c, hidden), (c, hidden)
        assert not fits(48, 8, c, hidden, train=True), (c, hidden)
    assert not fits(44, 8, 240, 480, train=True)  # not window-aligned
