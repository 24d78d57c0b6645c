"""Torch port's fused block halves vs the JAX package's Pallas kernels
(interpret mode), on the CPU, where the port's wrappers run their plain
versions.

Same inputs from a numpy seed through both: B=2, 16x24, C=24 (3 heads of
8), hidden 48, window 8, DropPath scales s = [1.0, 0.8]. Tolerance 3e-5,
that of the JAX package's own fused-block tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block as tfb

B, HH, WW, NH, HD, WS, HIDDEN = 2, 16, 24, 3, 8, 8, 48
C, N = NH * HD, WS * WS
S = np.asarray([1.0, 0.8], np.float32)


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


@pytest.mark.parametrize("shifted", [False, True])
def test_fused_attn_block_matches_jax(shifted):
    p = _params(np.random.default_rng(3 if shifted else 4))
    bias = p["rel"][None] + (shift_mask_kinds(WS, WS // 2)[:, None] if shifted else 0.0)
    bias = np.ascontiguousarray(bias, dtype=np.float32)
    args = [p[k] for k in ("x", "g", "be", "wq", "bq", "wp", "bp")] + [bias, S]
    want = np.asarray(
        jfb.fused_attn_block(*map(jnp.asarray, args), NH, HD, WS, 1e-5, True)
    )
    launches = tfb.fused_attn_block.launches
    got = tfb.fused_attn_block(*map(torch.from_numpy, args), NH, HD, WS, 1e-5)
    assert tfb.fused_attn_block.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


def test_fused_attn_block_shift_argument_matches_jax_rolls():
    """shift=s in the port equals the JAX contract: roll x by -s, run the
    kernel, roll z back by s."""
    p = _params(np.random.default_rng(6))
    s = WS // 2
    bias = np.ascontiguousarray(
        p["rel"][None] + shift_mask_kinds(WS, s)[:, None], dtype=np.float32
    )
    rest = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp")] + [bias, S]
    rolled = jnp.roll(jnp.asarray(p["x"]), (-s, -s), axis=(1, 2))
    z = jfb.fused_attn_block(rolled, *map(jnp.asarray, rest), NH, HD, WS, 1e-5, True)
    want = np.asarray(jnp.roll(z, (s, s), axis=(1, 2)))
    got = tfb.fused_attn_block(
        torch.from_numpy(p["x"]), *map(torch.from_numpy, rest), NH, HD, WS, 1e-5, shift=s
    )
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


def test_fused_ln_mlp_matches_jax():
    p = _params(np.random.default_rng(5))
    args = [p[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2")] + [S]
    want = np.asarray(jfb.fused_ln_mlp(*map(jnp.asarray, args), WS, 1e-5, True))
    launches = tfb.fused_ln_mlp.launches
    got = tfb.fused_ln_mlp(*map(torch.from_numpy, args), WS, 1e-5)
    assert tfb.fused_ln_mlp.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


def test_fused_block_gate(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    assert tfb.fused_block_supported(128, 128, 8, 180, 6, 360)  # SwinIR-M
    assert tfb.fused_block_supported(64, 64, 8, 240, 8, 480)  # SwinIR-L
    assert not tfb.fused_block_supported(128, 100, 8, 180, 6, 360)  # not window-aligned
    assert not tfb.fused_block_supported(256, 256, 16, 180, 6, 360)  # n=256: no room
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
    assert not tfb.fused_block_supported(128, 128, 8, 180, 6, 360)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "1")
    monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    assert not tfb.fused_block_supported(128, 128, 8, 180, 6, 360)


def test_shared_memory_plans_at_swinir_m():
    """The plans the kernels carve (csrc/fused_block.cu), fp32, at SwinIR-M's
    C=180, 6 heads of 30, hidden 360: transposed (C, 68) tiles, q/k (30, 68),
    v (64, 32), scores (64, 68), a 2 x 32 x 96 weight stage, LN stats."""
    stage = 2 * 32 * 96 + 128
    assert tfb.attn_block_smem_bytes(180, 6) == 4 * (
        2 * 180 * 68 + 2 * 30 * 68 + 64 * 32 + 64 * 68 + stage
    )
    assert tfb.ln_mlp_smem_bytes(180, 360) == 4 * (180 * 68 + 360 * 68 + stage)
    # SwinIR-L (C=240, 8 heads, hidden 480) fits too
    assert tfb.attn_block_smem_bytes(240, 8) <= tfb.SMEM_LIMIT
    assert tfb.ln_mlp_smem_bytes(240, 480) <= tfb.SMEM_LIMIT
