"""Torch port's window MHSA vs the JAX package's (Pallas kernel in interpret
mode), on the CPU, where the port's wrapper runs its plain version.

Same inputs from a numpy seed through both; B=2, 16x24, 3 heads of 8,
window 8, unshifted (K=1) and shifted (K=4). Tolerance 3e-5, that of the
JAX package's own kernel tests (fp32, other summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import window_attention as twa

B, HH, WW, NH, HD, WS = 2, 16, 24, 3, 8, 8
C, N = NH * HD, WS * WS


def _inputs(shifted: bool):
    rng = np.random.default_rng(0 if shifted else 1)
    qkv = rng.standard_normal((B, HH, WW, 3 * C)).astype(np.float32)
    rel = (rng.standard_normal((NH, N, N)) * 0.1).astype(np.float32)
    if shifted:
        bias = rel[None] + jwa.shift_mask_kinds(WS, WS // 2)[:, None]
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
    monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    assert not twa.fused_window_mhsa_supported(128, 128, 8, 180, 6)
