"""Torch port's attention half at 12x12 windows (TPU kernel #1, n = 144) and
its recompute backward (#6), and the MLP half's backward (#7) at hidden =
2C, against the JAX package's Pallas kernels in interpret mode and
`jax.vjp` of them, on the CPU, where the port's wrappers run their plain
versions.

Same inputs from a numpy seed through both: B=2, 24x24 (2x2 windows of
12x12), C=48 (2 heads of 24), hidden 96, DropPath scales s = [1.0, 0.8];
K=1 unshifted and K=4 shifted by 6 (the port indexes the shift, the JAX
side rolls around its call). The forward within 1e-4; every gradient
within 1e-4 of that tensor's largest magnitude. Also the gates and the
shared-memory plans at SRFormerV2's widths (C 240, 8 heads of 30, hidden
480): the staged #1/#6 and the two-pass #7 within one thread block's
232,448 bytes, the one-pass #7 not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block as tfb

B, HH, WW, NH, HD, WS, HIDDEN = 2, 24, 24, 2, 24, 12, 96
C, N = NH * HD, WS * WS
S = np.asarray([1.0, 0.8], np.float32)
ATTN = ("x", "g", "be", "wq", "bq", "wp", "bp")
GRADS = ("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias")


def _params(rng):
    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "x": normal(B, HH, WW, C),
        "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=0.2), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=0.2), "bp": normal(C, scale=0.1),
        "w1": normal(C, HIDDEN, scale=0.2), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=0.2), "b2": normal(C, scale=0.1),
        "rel": normal(NH, N, N, scale=0.1),
    }


def _bias(p, kinds):
    bias = p["rel"][None] + (shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0)
    return np.ascontiguousarray(bias, dtype=np.float32)


def _jax_attn(shift):
    """The JAX block at `shift`: roll x by -shift, the kernel, roll z back."""
    def f(x, g, be, wq, bq, wp, bp, bias):
        xr = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        z = jfb.fused_attn_block(xr, g, be, wq, bq, wp, bp, bias, jnp.asarray(S), NH, HD, WS,
                                 1e-5, True)
        return jnp.roll(z, (shift, shift), axis=(1, 2))
    return f


@pytest.mark.parametrize("kinds", [1, 4])
def test_fused_attn_block_ws12_matches_jax(kinds):
    p = _params(np.random.default_rng(10 + kinds))
    shift = WS // 2 if kinds == 4 else 0
    args = [p[k] for k in ATTN] + [_bias(p, kinds)]
    want = np.asarray(_jax_attn(shift)(*map(jnp.asarray, args)))
    launches = tfb.fused_attn_block.launches
    got = tfb.fused_attn_block(*map(torch.from_numpy, args), torch.from_numpy(S), NH, HD, WS,
                               1e-5, shift=shift)
    assert tfb.fused_attn_block.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kinds", [1, 4])
def test_fused_attn_block_backward_matches_jax_vjp(kinds):
    """#6's plain version, called directly and as fused_attn_block's
    autograd backward, against jax.vjp of the Pallas kernel (whose backward
    is the JAX package's #6)."""
    p = _params(np.random.default_rng(20 + kinds))
    shift = WS // 2 if kinds == 4 else 0
    args = [p[k] for k in ATTN] + [_bias(p, kinds)]
    dout = np.random.default_rng(30 + kinds).standard_normal((B, HH, WW, C)).astype(np.float32)
    _, vjp = jax.vjp(_jax_attn(shift), *map(jnp.asarray, args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    launches = tfb.fused_attn_block_backward.launches
    direct = tfb.fused_attn_block_backward(*map(torch.from_numpy, args), torch.from_numpy(S),
                                           torch.from_numpy(dout), NH, HD, WS, 1e-5, shift)
    assert tfb.fused_attn_block_backward.launches == launches  # CPU: the plain version
    ops = [torch.from_numpy(a).requires_grad_() for a in args]
    tfb.fused_attn_block(*ops, torch.from_numpy(S), NH, HD, WS, 1e-5,
                         shift=shift).backward(torch.from_numpy(dout))
    for got in (direct, [t.grad for t in ops]):
        for name, g, w in zip(GRADS, got, want):
            assert g.shape == w.shape, name
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


def test_fused_ln_mlp_backward_at_hidden_2c_matches_jax_vjp():
    """#7's plain version at (C, hidden) = (48, 96), SRFormerV2's ratio and
    12-row strips, against jax.vjp of the JAX fused_ln_mlp."""
    p = _params(np.random.default_rng(40))
    names = ("x", "g", "be", "w1", "b1", "w2", "b2")
    dout = np.random.default_rng(41).standard_normal((B, HH, WW, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfb.fused_ln_mlp(*a, jnp.asarray(S), WS, 1e-5, True),
                     *(jnp.asarray(p[k]) for k in names))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    got = tfb.fused_ln_mlp_backward(*(torch.from_numpy(p[k]) for k in names),
                                    torch.from_numpy(S), torch.from_numpy(dout), WS, 1e-5)
    for name, g, w in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


def test_gates_at_srformerv2_widths(monkeypatch):
    """The training block (72x72) and the serving one (144x144) of
    SRFormerV2's Swin blocks take #1/#6 and #2/#7; SwinIR's whole-block
    training kernels (#4/#5) stay at 8x8 windows."""
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    for side in (72, 144):
        assert tfb.fused_block_supported(side, side, 12, 240, 8, 480)
        assert tfb.attn_block_bwd_fits(side, side, 12, 240, 8)
        assert tfb.fused_mlp_supported(side, side, 12, 240, 480, train=True)
        assert not tfb.swin_block_train_fits(side, side, 12, 240, 8, 480)
    assert not tfb.fused_block_supported(72, 66, 12, 240, 8, 480)  # not window-aligned
    assert not tfb.attn_block_fits(72, 72, 12, 240, 6)  # heads of 40
    assert not tfb.attn_block_fits(80, 80, 10, 240, 8)  # 10x10: no plan
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
    assert not tfb.fused_block_supported(72, 72, 12, 240, 8, 480)


def _fma_forward_took(c: int, nh: int) -> bool:
    """The gate of the 12x12 forward before it moved to the tensor cores:
    heads of at most 32 channels and the largest shared memory of its three
    FMA kernels (LN + qkv and proj + residual on (C, 68) tiles and a 2 x 32
    x 96 weight stage, the attention's q, k, v and (48, 148) P rows) within
    one thread block's."""
    hd, stage = c // nh, 2 * 32 * 96
    floats = max(2 * c * 68 + stage + 128, c * 68 + stage, 2 * hd * 144 + 144 * 32 + 48 * 148)
    return c % nh == 0 and hd <= 32 and 4 * floats <= tfb.SMEM_LIMIT


@pytest.mark.parametrize(("c", "nh"), [(240, 8), (90, 3), (150, 5), (372, 12), (None, None)],
                         ids=["c240", "c90", "c150", "c372", "every_width"])
def test_12x12_gate_takes_every_shape_it_took(c, nh):
    """The 12x12 forward on the tensor-core stages takes every shape its FMA
    kernels took: SRFormerV2's C 240 / 8 heads, C 90 / 3 heads and C 150 /
    5 heads (not multiples of 4: 4-byte copies), C 372 / 12 heads (near the
    old limit), and every C up to 512 with each head count the old gate
    took."""
    cases = [(c, nh)] if c else [(cc, k) for cc in range(1, 513) for k in range(1, cc + 1)
                                 if cc % k == 0 and cc // k <= 32]
    took = [(cc, k) for cc, k in cases if _fma_forward_took(cc, k)]
    assert took
    for cc, k in took:
        assert tfb.attn_block_fits(72, 144, 12, cc, k), (cc, k)
    assert all(tfb.attn_block_fits(72, 72, 12, cc, k) for cc, k in cases)  # C <= 512 too


def test_shared_memory_plans_at_srformerv2_widths():
    """The plans the kernels carve (csrc/block_fwd.cuh, csrc/tc_attn.cuh,
    csrc/attn_block_staged.cu, csrc/tc_rows.cuh, csrc/fused_block_train.cu),
    fp32, at C 240, 8 heads of 30, hidden 480: the forward's tensor-core
    window attention k and v of 144 tokens and q and att of 48 rows padded to
    36 floats, the (48, 148) P tile, two (2, 48) exchanges and 144 token
    indices (85,056 bytes: two blocks a SM), under its per-token kernels'
    128-column tiles; the backward's tensor-core window attention k and
    v of 144 tokens and q, dA, att and dq of 48 rows padded to 36 floats,
    the (48, 148) P / dS tile, three (2, 48) exchanges and 144 token indices
    (99,264 bytes: two blocks a SM), under its largest per-token kernel; #6's and #7's engine: rings
    of 4 stages of a (128, 16) token chunk and a raw (256, 16) weight chunk
    spanning the C 240 row (rows of 20 floats; 16 bytes of mbarriers a
    stage besides), three buffers of the weight chunk's TF32 hi and lo
    tiles, the qkv kernel's 128-column tile and the hidden-unit kernel's
    (128, 128) tile of gelu'(h)."""
    attn_fwd = 2 * 144 * 36 + 2 * 48 * 36 + 48 * 148 + 4 * 48 + 144
    assert tfb.attn_fwd_tc_smem_bytes(144) == 4 * attn_fwd == 85_056
    assert 2 * (tfb.attn_fwd_tc_smem_bytes(144) + 1024) <= 228 * 1024  # two blocks a SM
    assert tfb.attn_block_smem_bytes(240, 12) == max(
        tfb.linear_smem_bytes(), tfb.residual_smem_bytes(240), 4 * attn_fwd) == 131_136
    attn_bwd = 2 * 144 * 36 + 4 * 48 * 36 + 48 * 148 + 6 * 48 + 144
    assert tfb.attn_rows_bwd_tc_smem_bytes(12) == 4 * attn_bwd == 99_264
    assert 2 * (tfb.attn_rows_bwd_tc_smem_bytes(12) + 1024) <= 228 * 1024  # two blocks a SM
    assert tfb.attn_rows_bwd_tc_smem_bytes(8) == 4 * (2 * 64 * 36 + 4 * 64 * 36 + 64 * 68
                                                      + 6 * 64 + 64)
    ring = 4 * (128 * 20 + 256 * 20) * 4 + 4 * 16  # token and raw weight chunks, mbarriers
    assert tfb.rows_smem_bytes(240) == 3 * 2 * 256 * 16 * 4 + ring == 221_248
    assert tfb.rows_smem_bytes(240) <= tfb.SMEM_LIMIT
    assert tfb.linear_smem_bytes() == 4 * (6 * 128 * 16 + 4 * 2 * 128 * 20 + 16) == 131_136
    assert tfb.attn_staged_bwd_smem_bytes(240, 8, 12) == max(
        tfb.linear_smem_bytes(), tfb.rows_smem_bytes(240), 4 * attn_bwd) == 221_248
    assert tfb.mlp_hidden_smem_bytes() == 4 * (128 * 128 + 6 * 128 * 16 + 4 * 2 * 128 * 20 + 16)
    assert tfb.weight_grad_smem_bytes() == 4 * (6 * 128 * 32 + 3 * (2 * 32 * 136 + 4)) == 202_800
    assert tfb.ln_mlp_bwd_fits(240, 480)
    assert tfb.ln_mlp_bwd_fits(180, 360)  # HAT-M: a 192-column tile
    assert tfb.rows_smem_bytes(180) == 4 * (6 * 192 * 16 + 4 * (128 * 20 + 192 * 20) + 16)
