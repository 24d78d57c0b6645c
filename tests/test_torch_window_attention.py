"""Torch port's window MHSA vs the JAX package's (Pallas kernels in interpret
mode), on the CPU, where the port's wrapper runs its plain versions.

Same inputs from a numpy seed through both; B=2, 16x24, 3 heads of 8,
window 8, unshifted (K=1) and shifted (K=4). Tolerance 3e-5, that of the
JAX package's own kernel tests (fp32, other summation order). HAT's 16x16
windows at B=1, 32x48, 2 heads of 8. The backward (TPU kernel #8: dqkv and
dbias) against `jax.vjp` of the JAX kernel at both window sizes, K=1 and
K=4, within 1e-4 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    assert not twa.fused_window_mhsa_supported(64, 64, 16, 240, 6)  # heads of 40
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
    """HAT-M's heads (C 180, 6 heads of 30) at 16x16 windows: the forward
    takes 138 KB of shared memory and the backward 193 KB, both within one
    thread block's 227 KB; SwinIR-M's 8x8 plans stay as they were."""
    assert twa.window_mhsa_smem_bytes(180, 6, 16) == 4 * (30 * 68 + 30 * 256 + 256 * 32 + 64 * 260)
    assert twa.window_mhsa_bwd_smem_bytes(180, 6, 16) == 4 * (
        2 * 30 * 256 + 256 * 32 + 2 * 30 * 68 + 2 * 64 * 32 + 64 * 260)
    assert twa.window_mhsa_bwd_smem_bytes(180, 6, 16) <= twa.SMEM_LIMIT
    assert twa.window_mhsa_smem_bytes(180, 6) == 4 * (2 * 30 * 68 + 64 * 32 + 64 * 68)
