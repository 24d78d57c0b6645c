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
    assert not gate(64, 64, 8, 240, 8, 480, train=True)  # ...but #14 has no room to train
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
    """The plans the kernels carve (csrc/fused_block_v2.cu), fp32, at
    Swin2SR-M's C=180, 6 heads of 30, hidden 360: transposed (C, 68)
    tiles, the (64, C + 1) rows of the post-norm, a 2 x 32 x 96 weight
    stage."""
    stage = 2 * 32 * 96
    assert tv2.cos_attn_fwd_smem_bytes(180, 6) == 4 * (
        2 * 180 * 68 + 2 * 30 * 68 + 64 * 32 + 64 * 68 + stage + 128)
    assert tv2.pn_mlp_fwd_smem_bytes(180, 360) == 4 * (180 * 68 + 360 * 68 + stage)
    assert tv2.postnorm_ln_bwd_smem_bytes(180) == 4 * (64 * 181 + 180 * 68 + stage + 192)
    assert tv2.cos_attn_bwd_smem_bytes(30) == 4 * (4 * 64 * 32 + 4 * 30 * 68 + 3 * 64 * 68
                                                   + 128 + 8)
    assert tv2.qkv_dx_smem_bytes(180) == 4 * (3 * 180 * 68 + stage)
    assert tv2.pn_mlp_bwd_smem_bytes(180, 360) == 4 * (2 * 180 * 68 + 360 * 68 + stage + 192)
    # the post-norm rows fit the (C, 68) tile they share from C = 16 on
    assert all(64 * (c + 1) <= c * 68 for c in (16, 60, 180, 240))
    assert max(tv2.pn_mlp_bwd_smem_bytes(180, 360), tv2.qkv_dx_smem_bytes(180)) <= tv2.SMEM_LIMIT
    assert tv2.pn_mlp_bwd_smem_bytes(240, 480) > tv2.SMEM_LIMIT
