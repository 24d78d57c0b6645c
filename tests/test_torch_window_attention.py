"""Torch port's window MHSA vs the JAX package's (Pallas kernels in interpret
mode), on the CPU, where the port's wrapper runs its plain versions.

Same inputs from a numpy seed through both; B=2, 16x24, 3 heads of 8,
window 8, unshifted (K=1) and shifted (K=4). Tolerance 3e-5, that of the
JAX package's own kernel tests (fp32, other summation order). HAT's 16x16
windows at B=1, 32x48, 2 heads of 8. The backward (TPU kernel #8: dqkv and
dbias) against `jax.vjp` of the JAX kernel at both window sizes, K=1 and
K=4, within 1e-4 of each gradient's largest magnitude. DAT's rectangles
(`fused_rect_mhsa`, n = 128: 8x16 and 16x8) at B=2, 32x32, 2 heads of 8,
K=1 and K=4: the forward within 1e-5, dqkv and dbias within 1e-4 of max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import window_attention as twa

B, HH, WW, NH, HD, WS = 2, 16, 24, 3, 8, 8
C, N = NH * HD, WS * WS


# (B, H, W, heads, head_dim) of the two window sizes' cases
SHAPES = {8: (B, HH, WW, NH, HD), 16: (1, 32, 48, 2, 8)}


def _inputs(shifted: bool, ws: int = WS):
    b, hh, ww, nh, hd = SHAPES[ws]
    rng = np.random.default_rng((0 if shifted else 1) + ws - WS)
    qkv = rng.standard_normal((b, hh, ww, 3 * nh * hd)).astype(np.float32)
    rel = (rng.standard_normal((nh, ws * ws, ws * ws)) * 0.1).astype(np.float32)
    if shifted:
        bias = rel[None] + jwa.shift_mask_kinds(ws, ws // 2)[:, None]
    else:
        bias = rel[None]
    return qkv, np.ascontiguousarray(bias, dtype=np.float32)


@pytest.mark.parametrize(("window_size", "shift"), [(8, 4), (8, 2), (4, 2), (7, 3)])
def test_shift_mask_kinds_equal(window_size, shift):
    np.testing.assert_array_equal(
        twa.shift_mask_kinds(window_size, shift), jwa.shift_mask_kinds(window_size, shift)
    )


@pytest.mark.parametrize("shifted", [False, True])
def test_fused_window_mhsa_matches_jax(shifted):
    qkv, bias = _inputs(shifted)
    want = np.asarray(jwa.fused_window_mhsa(jnp.asarray(qkv), jnp.asarray(bias), NH, HD, WS, True))
    launches = twa.fused_window_mhsa.launches
    got = twa.fused_window_mhsa(torch.from_numpy(qkv), torch.from_numpy(bias), NH, HD, WS)
    assert twa.fused_window_mhsa.launches == launches  # CPU: the plain version, no kernel
    assert got.shape == (B, HH, WW, C)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("shifted", [False, True])
def test_reference_window_mhsa_matches_jax(shifted):
    """The per-window-bias plain version against the JAX plain version."""
    qkv, bias = _inputs(shifted)
    nwh, nww = HH // WS, WW // WS
    idx = twa.window_kinds(nwh, nww, bias.shape[0]).numpy()
    bias_full = bias[idx]
    want = np.asarray(
        jwa.reference_window_mhsa(jnp.asarray(qkv), jnp.asarray(bias_full), NH, HD, WS)
    )
    got = twa.reference_window_mhsa(torch.from_numpy(qkv), torch.from_numpy(bias_full), NH, HD, WS)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


def test_window_kinds_layout():
    """Kind of each window: 2 * is_bottom_row + is_rightmost (row-major)."""
    kinds = twa.window_kinds(2, 3, 4).tolist()
    assert kinds == [0, 0, 1, 2, 2, 3]
    assert twa.window_kinds(2, 3, 1).tolist() == [0] * 6


def test_window_mhsa_gate(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    assert twa.fused_window_mhsa_supported(128, 128, 8, 180, 6)  # SwinIR-M
    assert twa.fused_window_mhsa_supported(64, 64, 8, 240, 8)  # SwinIR-L
    assert not twa.fused_window_mhsa_supported(20, 128, 8, 180, 6)  # not window-aligned
    assert not twa.fused_window_mhsa_supported(512, 512, 32, 180, 6)  # n=1024: no room
    assert twa.fused_window_mhsa_supported(64, 64, 16, 180, 6)  # HAT-M
    assert twa.fused_window_mhsa_supported(64, 64, 16, 240, 6)  # heads of 40: 64-wide rows
    assert twa.fused_window_mhsa_supported(64, 64, 16, 390, 6)  # heads of 65: 128-wide
    assert not twa.fused_window_mhsa_supported(64, 64, 16, 774, 6)  # heads of 129
    assert not twa.fused_window_mhsa_supported(48, 48, 12, 180, 6)  # 12x12 windows
    monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    assert not twa.fused_window_mhsa_supported(128, 128, 8, 180, 6)


@pytest.mark.parametrize("shifted", [False, True])
def test_fused_window_mhsa_ws16_matches_jax(shifted):
    """HAT's 16x16 windows (n = 256), the forward kernel's second variant."""
    qkv, bias = _inputs(shifted, 16)
    _, _, _, nh, hd = SHAPES[16]
    want = np.asarray(jwa.fused_window_mhsa(jnp.asarray(qkv), jnp.asarray(bias), nh, hd, 16, True))
    got = twa.fused_window_mhsa(torch.from_numpy(qkv), torch.from_numpy(bias), nh, hd, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("ws", [8, 16])
@pytest.mark.parametrize("shifted", [False, True])
def test_fused_window_mhsa_backward_matches_jax_vjp(ws, shifted):
    qkv, bias = _inputs(shifted, ws)
    b, hh, ww, nh, hd = SHAPES[ws]
    dout = np.random.default_rng(5).standard_normal((b, hh, ww, nh * hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, t: jwa.fused_window_mhsa(q, t, nh, hd, ws, True),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    launches = twa.fused_window_mhsa_backward.launches
    direct = twa.fused_window_mhsa_backward(torch.from_numpy(qkv), torch.from_numpy(bias),
                                            torch.from_numpy(dout), nh, hd, ws)
    assert twa.fused_window_mhsa_backward.launches == launches  # CPU: the plain version
    # and through autograd, as the archs reach it
    q = torch.from_numpy(qkv).requires_grad_()
    t = torch.from_numpy(bias).requires_grad_()
    twa.fused_window_mhsa(q, t, nh, hd, ws).backward(torch.from_numpy(dout))
    for got in (direct, (q.grad, t.grad)):
        for name, g, w in zip(("dqkv", "dbias"), got, want):
            assert g.shape == w.shape, name
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


def test_window_mhsa_plans_at_hat_m():
    """HAT-M's heads (C 180, 6 heads of 30) at 16x16 windows: the
    tensor-core forward (k and v of the 256 tokens and q and att of a 64-row
    block in rows of 36 floats, the (64, 260) P tile, two (4, 64) exchanges
    of the key quarters' row max and sum, the token indices) takes 161,792
    bytes of shared memory, one block of 16 warps a SM; the backward (q, dA
    and dq of the row block, three exchanges) 172 KB, one block a SM; at 8x8
    windows both fit three blocks a SM, SwinIR-M's forward on the pre-LN
    block forwards' plan."""
    assert twa.window_mhsa_smem_bytes(180, 6, 16) == 4 * (
        2 * 256 * 36 + 2 * 64 * 36 + 64 * 260 + 2 * 4 * 64 + 256) == 161_792
    assert twa.window_mhsa_smem_bytes(180, 6, 16) <= twa.SMEM_LIMIT
    assert twa.TC_ATTN_PLANS[256] == (64, 4)
    assert twa.window_mhsa_bwd_smem_bytes(180, 6, 16) == 4 * (
        2 * 256 * 36 + 3 * 64 * 36 + 64 * 260 + 3 * 4 * 64 + 256) == 172_032
    assert twa.window_mhsa_bwd_smem_bytes(180, 6, 16) <= twa.SMEM_LIMIT
    assert twa.window_mhsa_bwd_smem_bytes(180, 6, 8) == 4 * (
        2 * 64 * 36 + 3 * 64 * 36 + 64 * 68 + 3 * 2 * 64 + 64)
    assert 3 * (twa.window_mhsa_bwd_smem_bytes(180, 6, 8) + 1024) <= 228 * 1024
    assert twa.window_mhsa_smem_bytes(180, 6) == 4 * (
        2 * 64 * 36 + 2 * 64 * 36 + 64 * 68 + 2 * 2 * 64 + 64) == 55_552
    assert 3 * (twa.window_mhsa_smem_bytes(180, 6) + 1024) <= 228 * 1024


# DAT's rect windows: (h_sp, w_sp) -> the shift of a shifted block
RECT = {(8, 16): (4, 8), (16, 8): (8, 4)}
RB, RH, RW, RNH, RHD = 2, 32, 32, 2, 8


def _rect_inputs(h_sp: int, w_sp: int, kinds: int):
    rng = np.random.default_rng(h_sp + 10 * kinds)
    n = h_sp * w_sp
    qkv = rng.standard_normal((RB, RH, RW, 3 * RNH * RHD)).astype(np.float32)
    rel = (rng.standard_normal((RNH, n, n)) * 0.1).astype(np.float32)
    if kinds == 4:
        bias = rel[None] + jwa.rect_shift_mask_kinds(h_sp, w_sp, *RECT[h_sp, w_sp])[:, None]
    else:
        bias = rel[None]
    dout = rng.standard_normal((RB, RH, RW, RNH * RHD)).astype(np.float32)
    return qkv, np.ascontiguousarray(bias, dtype=np.float32), dout


@pytest.mark.parametrize(("h_sp", "w_sp", "sh", "sw"),
                         [(8, 32, 4, 16), (32, 8, 16, 4), (8, 16, 4, 8), (2, 4, 1, 2)])
def test_rect_shift_mask_kinds_equal(h_sp, w_sp, sh, sw):
    np.testing.assert_array_equal(twa.rect_shift_mask_kinds(h_sp, w_sp, sh, sw),
                                  jwa.rect_shift_mask_kinds(h_sp, w_sp, sh, sw))


@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize("window", list(RECT))
def test_fused_rect_mhsa_matches_jax(window, kinds):
    """The forward (#3's rect form) and, through autograd and the direct
    entry, the backward (#8's) against the JAX kernel and `jax.vjp`."""
    h_sp, w_sp = window
    qkv, bias, dout = _rect_inputs(h_sp, w_sp, kinds)
    out, vjp = jax.vjp(lambda q, t: jwa.fused_rect_mhsa(q, t, RNH, RHD, h_sp, w_sp, True),
                       jnp.asarray(qkv), jnp.asarray(bias))
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    launches = (twa.fused_rect_mhsa.launches, twa.fused_rect_mhsa_backward.launches)
    q = torch.from_numpy(qkv).requires_grad_()
    t = torch.from_numpy(bias).requires_grad_()
    got = twa.fused_rect_mhsa(q, t, RNH, RHD, h_sp, w_sp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    got.backward(torch.from_numpy(dout))
    direct = twa.fused_rect_mhsa_backward(torch.from_numpy(qkv), torch.from_numpy(bias),
                                          torch.from_numpy(dout), RNH, RHD, h_sp, w_sp)
    # CPU: the plain versions, no kernel
    assert (twa.fused_rect_mhsa.launches, twa.fused_rect_mhsa_backward.launches) == launches
    for grads in ((q.grad, t.grad), direct):
        for name, g, w in zip(("dqkv", "dbias"), grads, want_g):
            assert g.shape == w.shape, name
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


def test_square_windows_are_the_rect_ones():
    """The square entries' plain versions are the rect ones at wr = wc."""
    qkv, bias = _inputs(True, 16)
    _, _, _, nh, hd = SHAPES[16]
    q, t = torch.from_numpy(qkv), torch.from_numpy(bias)
    torch.testing.assert_close(twa.fused_window_mhsa_reference(q, t, nh, hd, 16),
                               twa.fused_rect_mhsa_reference(q, t, nh, hd, 16, 16),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(twa.shift_mask_kinds(8, 4), jwa.shift_mask_kinds(8, 4))


def test_rect_mhsa_gate(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    assert twa.fused_rect_mhsa_supported(64, 64, 8, 32, 90, 3)  # DAT's branches
    assert twa.fused_rect_mhsa_supported(64, 64, 32, 8, 90, 3)
    assert twa.fused_rect_mhsa_supported(128, 128, 16, 8, 90, 3)  # dat_s
    assert twa.fused_rect_mhsa_supported(64, 64, 8, 32, 30, 3)  # dat_light: heads of 10
    assert not twa.fused_rect_mhsa_supported(48, 64, 32, 8, 90, 3)  # H not a multiple of 32
    assert not twa.fused_rect_mhsa_supported(64, 64, 2, 4, 8, 1)  # n = 8
    assert twa.fused_rect_mhsa_supported(64, 64, 8, 32, 120, 3)  # heads of 40: 64-wide rows
    assert twa.fused_rect_mhsa_supported(64, 64, 8, 32, 195, 3)  # heads of 65: 128-wide
    assert not twa.fused_rect_mhsa_supported(64, 64, 8, 32, 387, 3)  # heads of 129
    assert not twa.fused_rect_mhsa_supported(64, 64, 16, 32, 90, 3)  # n = 512
    monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    assert not twa.fused_rect_mhsa_supported(64, 64, 8, 32, 90, 3)


def _fma_forward_smem(c: int, nh: int, wr: int, wc: int) -> int:
    """Shared memory of the FMA forwards #3 ran before it moved to the tensor
    cores: at 8x8 q and k transposed in (hd, 68) tiles, v (64, 32) and the
    (64, 68) scores; at n 128 and 256 a row block's q (hd, 68), k (hd, n), v
    (n, 32) and the (64, n + 4) P rows."""
    hd, n = c // nh, wr * wc
    if wr == wc == 8:
        return 4 * (2 * hd * 68 + 64 * 32 + 64 * 68)
    return 4 * (hd * 68 + hd * n + n * 32 + 64 * (n + 4))


@pytest.mark.parametrize("window", [(8, 8), (16, 16), (8, 32), (32, 8), (8, 16), (16, 8)],
                         ids=lambda w: f"{w[0]}x{w[1]}")
def test_rect_gate_takes_every_shape_it_took(window):
    """#3's gate on the tensor-core forward takes every shape it took on the
    FMA kernels: every C up to 512 and head count of at most 32 channels
    (widths not multiples of 4 among them: C 90 / 3 heads, DAT's branch),
    at its window and map sizes that are and are not window-aligned."""
    wr, wc = window
    took = 0
    for c in range(1, 513):
        for nh in range(1, c + 1):
            if c % nh or c // nh > 32:
                continue
            old = max(_fma_forward_smem(c, nh, wr, wc),
                      twa.rect_mhsa_bwd_smem_bytes(c, nh, wr, wc)) <= twa.SMEM_LIMIT
            for h, w in ((64, 64), (2 * wr, 3 * wc), (wr + 4, wc)):
                was = old and h % wr == 0 and w % wc == 0
                assert twa.rect_mhsa_fits(h, w, wr, wc, c, nh) == was, (c, nh, h, w)
                took += was
    assert took
    assert twa.rect_mhsa_fits(64, 64, wr, wc, 90, 3)


def test_rect_mhsa_plans_at_dat():
    """DAT's branch (90 channels, 3 heads of 30) at n = 256 takes the ws-16
    plans (161,792 bytes forward, 172 KB backward); dat_s's n = 128 less,
    the forward and the backward two blocks a SM each."""
    for window in ((8, 32), (32, 8)):
        assert twa.rect_mhsa_smem_bytes(90, 3, *window) == twa.window_mhsa_smem_bytes(180, 6, 16)
        assert twa.rect_mhsa_bwd_smem_bytes(90, 3, *window) == (
            twa.window_mhsa_bwd_smem_bytes(180, 6, 16))
    assert twa.rect_mhsa_smem_bytes(90, 3, 8, 16) == 4 * (
        2 * 128 * 36 + 2 * 32 * 36 + 32 * 132 + 2 * 4 * 32 + 128) == 64_512
    assert 2 * (twa.rect_mhsa_smem_bytes(90, 3, 16, 8) + 1024) <= 228 * 1024
    assert twa.TC_ATTN_PLANS[128] == (32, 4)  # rows of 32, four warps a row tile
    assert twa.rect_mhsa_bwd_smem_bytes(90, 3, 16, 8) == 4 * (
        2 * 128 * 36 + 3 * 32 * 36 + 32 * 132 + 3 * 4 * 32 + 128)
    assert 2 * (twa.rect_mhsa_bwd_smem_bytes(90, 3, 16, 8) + 1024) <= 228 * 1024
