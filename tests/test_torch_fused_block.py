"""Torch port's fused block halves vs the JAX package's Pallas kernels
(interpret mode), on the CPU, where the port's wrappers run their plain
versions.

Same inputs from a numpy seed through both: B=2, 16x24, C=24 (3 heads of
8), hidden 48, window 8, DropPath scales s = [1.0, 0.8]. Tolerance 3e-5,
that of the JAX package's own fused-block tests. The MLP half's backward
(TPU kernel #7) against `jax.vjp` of the JAX kernel, within 1e-4 of each
gradient's largest magnitude.
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
    """The plans the forward stages carve (csrc/block_fwd.cuh on
    csrc/tc_rows.cuh and csrc/tc_attn.cuh), fp32, at SwinIR-M's C=180, 6
    heads of 30, hidden 360. A per-token kernel holds the split buffers of
    a (cols, 16) weight chunk's TF32 halves, then a 4-stage ring of a (128,
    16) token chunk in rows of 20 and a raw weight chunk's room (the larger
    of (cols, 20) and (16, cols + 8)), two mbarriers a stage. qkv and fc1
    take linear_kernel's 128-column tiles, the largest plan; proj and fc2
    two 96-column tiles of the residual product; the window attention k, v,
    q and att rows of 36, the (64, 68) P tile, the key parts' exchanges and
    64 token indices."""
    col128 = 4 * 3 * 2 * 128 * 16 + 4 * (4 * (128 * 20 + 128 * 20) + 16)
    col96 = 4 * 3 * 2 * 96 * 16 + 4 * (4 * (128 * 20 + 96 * 20) + 16)
    window = 4 * (2 * 64 * 36 + 2 * 64 * 36 + 64 * 68 + 2 * 2 * 64 + 64)
    assert (col128, col96, window) == (131_136, 108_608, 55_552)
    assert tfb.linear_smem_bytes() == col128
    assert tfb.residual_tile_cols(180) == 96 and tfb.residual_smem_bytes(180) == col96
    assert tfb.attn_fwd_tc_smem_bytes(64) == window
    assert tfb.attn_block_smem_bytes(180) == tfb.ln_mlp_smem_bytes(180) == col128
    # SwinIR-L (C=240) and C 300 on 128-column tiles of the residual product,
    # C 60 on one of 64
    assert [tfb.residual_tile_cols(c) for c in (240, 300, 60)] == [128, 128, 64]
    assert tfb.attn_block_smem_bytes(240) == tfb.ln_mlp_smem_bytes(300) == col128


# (preset, branch kind, C, heads, window, hidden): the blocks of the three
# families whose forwards run the pre-LN block kernels. "swin": SwinIR's
# SwinBlock (archs/swinir_arch.py), the kernels in training only where
# swin_block_train_fits holds; "mlp": HAT's HAB and OCAB MLP halves
# (archs/fused_block_util.py); "swin12": SRFormerV2's Swin blocks
# (archs/srformerv2_arch.py), in training where both backwards fit.
FAMILY_BLOCKS = {
    "swinir_s": ("swin", 60, 6, 8, 120), "swinir_m": ("swin", 180, 6, 8, 360),
    "swinir_l": ("swin", 240, 8, 8, 480), "hat_s": ("mlp", 144, 6, 16, 288),
    "hat_m": ("mlp", 180, 6, 16, 360), "hat_l": ("mlp", 180, 6, 16, 360),
    "srformerv2": ("swin12", 240, 8, 12, 480),
}
FAMILY_MAPS = ((64, 64), (144, 144), (72, 96), (40, 56))
# 1 where the block takes the kernels, at each map serving then training,
# as the gates decided before the forwards moved to the tensor cores
FAMILY_BRANCHES = {
    "swinir_s": [1, 1, 1, 1, 1, 1, 1, 1], "swinir_m": [1, 1, 1, 1, 1, 1, 1, 1],
    "swinir_l": [1, 0, 1, 0, 1, 0, 1, 0], "hat_s": [1, 1, 1, 1, 0, 0, 0, 0],
    "hat_m": [1, 1, 1, 1, 0, 0, 0, 0], "hat_l": [1, 1, 1, 1, 0, 0, 0, 0],
    "srformerv2": [0, 0, 1, 1, 1, 1, 0, 0],
}


def _takes_kernels(kind, c, nh, ws, hidden, h, w, train):
    if kind == "mlp":
        return tfb.fused_mlp_supported(h, w, ws, c, hidden, train)
    fused = tfb.fused_block_supported(h, w, ws, c, nh, hidden)
    if fused and train:
        if kind == "swin":
            return tfb.swin_block_train_fits(h, w, ws, c, nh, hidden)
        return tfb.attn_block_bwd_fits(h, w, ws, c, nh) and tfb.ln_mlp_bwd_fits(c, hidden)
    return fused


@pytest.mark.parametrize("preset", list(FAMILY_BLOCKS))
def test_family_presets_keep_their_branches(preset, monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    got = [int(_takes_kernels(*FAMILY_BLOCKS[preset], h, w, train))
           for h, w in FAMILY_MAPS for train in (False, True)]
    assert got == FAMILY_BRANCHES[preset]


@pytest.mark.parametrize("scales", [[1.0, 0.8], [0.0, 1.0 / 0.9]])
def test_fused_ln_mlp_backward_matches_jax_vjp(scales):
    p = _params(np.random.default_rng(7))
    s = np.asarray(scales, np.float32)
    names = ("x", "g", "be", "w1", "b1", "w2", "b2")
    dout = np.random.default_rng(8).standard_normal((B, HH, WW, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfb.fused_ln_mlp(*a, jnp.asarray(s), WS, 1e-5, True),
                     *(jnp.asarray(p[k]) for k in names))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    launches = tfb.fused_ln_mlp_backward.launches
    direct = tfb.fused_ln_mlp_backward(*(torch.from_numpy(p[k]) for k in names),
                                       torch.from_numpy(s), torch.from_numpy(dout), WS, 1e-5)
    assert tfb.fused_ln_mlp_backward.launches == launches  # CPU: the plain version
    ops = [torch.from_numpy(p[k]).requires_grad_() for k in names]
    tfb.fused_ln_mlp(*ops, torch.from_numpy(s), WS, 1e-5).backward(torch.from_numpy(dout))
    for got in (direct, [t.grad for t in ops]):
        for name, g, w in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"), got, want):
            assert g.shape == w.shape, name
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


def test_fused_mlp_gate(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    assert tfb.fused_mlp_supported(64, 64, 16, 180, 360, train=True)  # HAT-M
    assert tfb.fused_mlp_supported(64, 64, 8, 240, 480)  # SwinIR-L widths serve...
    # ...and train, on the backward's two-pass plan
    assert tfb.fused_mlp_supported(64, 64, 8, 240, 480, train=True)
    assert tfb.fused_mlp_supported(64, 64, 8, 300, 300)  # C 300, hidden 300 serve...
    # ...and train, on the split rows stage (rows of up to 320 channels)
    assert tfb.fused_mlp_supported(64, 64, 8, 300, 300, train=True)
    assert tfb.fused_mlp_supported(64, 64, 8, 324, 324)  # C 324 serves...
    assert not tfb.fused_mlp_supported(64, 64, 8, 324, 324, train=True)  # ...not train
    assert not tfb.fused_mlp_supported(60, 64, 16, 180, 360)  # H not a multiple of rows
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
    assert not tfb.fused_mlp_supported(64, 64, 16, 180, 360)
