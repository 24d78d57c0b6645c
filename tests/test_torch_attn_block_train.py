"""Torch port's training form of the attention half, `fused_attn_block_train`
(TPU kernels #9 and #10: the forward saving P and the attention output, and
the saved-P backward), against the JAX package's Pallas kernels in interpret
mode and `jax.vjp` of them, on the CPU, where the port's wrappers run their
plain versions.

Same inputs from a numpy seed through both: C=24 (3 heads of 8); 8x8
windows at B=2, 16x16 and 12x12 windows at B=1, 24x24; K=1 unshifted and
K=4 shifted by half the window (the port indexes the shift; the JAX input
is rolled by (-shift, -shift) and its z and att rolled back, its P compared
as it stands). The forward within 1e-5; every gradient within 1e-4 of that
tensor's largest magnitude. The port's own pairs within 2e-5, as the JAX
package's tests/test_archs/test_fused_block_train.py holds its own: the
saved-P backward against the recompute one (`fused_attn_block`), and the
training form followed by `fused_ln_mlp` against the whole training block
`fused_swin_block_train`. Also the gate and the shared-memory plan.
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

NH, HD, HIDDEN = 3, 8, 48
C = NH * HD
ATTN = ("x", "g", "be", "wq", "bq", "wp", "bp")
GRADS = ("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias")
# (window, kinds) -> (batch, side): 2x2 windows of 8x8, 2x2 of 12x12
CASES = [(8, 1), (8, 4), (12, 1), (12, 4)]
SHAPES = {8: (2, 16), 12: (1, 24)}


def _inputs(ws, kinds, seed):
    b, side = SHAPES[ws]
    n = ws * ws
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {
        "x": normal(b, side, side, C),
        "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=0.2), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=0.2), "bp": normal(C, scale=0.1),
        "g2": 1.0 + normal(C, scale=0.1), "be2": normal(C, scale=0.1),
        "w1": normal(C, HIDDEN, scale=0.2), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=0.2), "b2": normal(C, scale=0.1),
        "s": np.asarray([1.0, 0.8][:b], np.float32),
        "s2": np.asarray([0.0, 1.0 / 0.9][:b], np.float32),
        "dout": normal(b, side, side, C),
    }
    bias = normal(NH, n, n, scale=0.1)[None]
    if kinds == 4:
        bias = bias + shift_mask_kinds(ws, ws // 2)[:, None]
    p["bias"] = np.ascontiguousarray(bias, dtype=np.float32)
    return p, (ws // 2 if kinds == 4 else 0)


def _roll(a, shift):
    return jnp.roll(a, (shift, shift), axis=(1, 2))


def _torch(p, names):
    return [torch.from_numpy(p[k]) for k in names]


@pytest.mark.parametrize(("ws", "kinds"), CASES)
def test_forward_matches_jax(ws, kinds):
    """z, P and att of the plain version against the JAX kernel's
    (`_attn_fwd_train_impl`, interpret mode)."""
    p, shift = _inputs(ws, kinds, 10 + ws + kinds)
    args = [jnp.asarray(p[k]) for k in (*ATTN, "bias", "s")]
    args[0] = _roll(args[0], -shift)
    z, P, att = jfb._attn_fwd_train_impl(*args, NH, HD, ws, 1e-5, True)
    want = {"z": np.asarray(_roll(z, shift)), "P": np.asarray(P),
            "att": np.asarray(_roll(att, shift))}
    launches = tfb.fused_attn_block_train.launches
    got = tfb.fused_attn_block_train_reference(*_torch(p, (*ATTN, "bias", "s")), NH, HD, ws,
                                               1e-5, shift)
    z_fn = tfb.fused_attn_block_train(*_torch(p, (*ATTN, "bias", "s")), NH, HD, ws, 1e-5,
                                      shift=shift)
    assert tfb.fused_attn_block_train.launches == launches  # CPU: the plain version
    assert torch.equal(z_fn, got[0])
    for name, g in zip(("z", "P", "att"), got):
        assert g.shape == want[name].shape, name
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize(("ws", "kinds"), CASES)
def test_backward_matches_jax_vjp(ws, kinds):
    """The 8 gradients of `fused_attn_block_train` (its autograd backward and
    the plain saved-P backward called directly) against jax.vjp of the JAX
    fused_attn_block_train, whose backward is the JAX package's #10."""
    p, shift = _inputs(ws, kinds, 20 + ws + kinds)
    s = jnp.asarray(p["s"])

    def f(x, g, be, wq, bq, wp, bp, bias):
        z = jfb.fused_attn_block_train(_roll(x, -shift), g, be, wq, bq, wp, bp, bias, s, NH, HD,
                                       ws, 1e-5, True)
        return _roll(z, shift)

    _, vjp = jax.vjp(f, *(jnp.asarray(p[k]) for k in (*ATTN, "bias")))
    want = [np.asarray(g) for g in vjp(jnp.asarray(p["dout"]))]

    ops = [t.requires_grad_() for t in _torch(p, (*ATTN, "bias"))]
    z = tfb.fused_attn_block_train(*ops, torch.from_numpy(p["s"]), NH, HD, ws, 1e-5, shift=shift)
    launches = tfb.fused_attn_block_train_backward.launches
    z.backward(torch.from_numpy(p["dout"]))
    _, P, att = tfb.fused_attn_block_train_reference(*(t.detach() for t in ops),
                                                     torch.from_numpy(p["s"]), NH, HD, ws, 1e-5,
                                                     shift)
    direct = tfb.fused_attn_block_train_backward(*_torch(p, ATTN), torch.from_numpy(p["s"]), P,
                                                 att, torch.from_numpy(p["dout"]), kinds, NH, HD,
                                                 ws, 1e-5, shift)
    assert tfb.fused_attn_block_train_backward.launches == launches  # CPU: the plain version
    for got in ([t.grad for t in ops], direct):
        for name, g, w in zip(GRADS, got, want):
            assert g.shape == w.shape, name
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err:.3g} of {np.abs(w).max():.3g}"


@pytest.mark.parametrize(("ws", "kinds"), CASES)
def test_saved_p_matches_recompute(ws, kinds):
    """The port's saved-P pair against its recompute pair (#1 and #6's plain
    versions) on the same inputs: z and the 8 gradients of sum(z^2)."""
    p, shift = _inputs(ws, kinds, 30 + ws + kinds)
    runs = []
    for fn in (tfb.fused_attn_block_train, tfb.fused_attn_block):
        ops = [t.requires_grad_() for t in _torch(p, (*ATTN, "bias"))]
        z = fn(*ops, torch.from_numpy(p["s"]), NH, HD, ws, 1e-5, shift=shift)
        runs.append([z.detach(), *torch.autograd.grad(z.square().sum(), ops)])
    for name, a, b in zip(("z", *GRADS), *runs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("kinds", [1, 4])
def test_with_mlp_matches_swin_block_train(kinds):
    """`fused_attn_block_train` then `fused_ln_mlp` against the whole
    training block (#4/#5's plain versions), which the JAX package calls
    numerically identical: out and the 14 gradients of sum(out^2)."""
    p, shift = _inputs(8, kinds, 40 + kinds)
    mlp = ("g2", "be2", "w1", "b1", "w2", "b2")
    names = (*ATTN, "bias", *mlp)
    s1, s2 = torch.from_numpy(p["s"]), torch.from_numpy(p["s2"])
    ops = [t.requires_grad_() for t in _torch(p, names)]
    z = tfb.fused_attn_block_train(*ops[:8], s1, NH, HD, 8, 1e-5, shift=shift)
    out = tfb.fused_ln_mlp(z, *ops[8:], s2, 8, 1e-5)
    halves = [out.detach(), *torch.autograd.grad(out.square().sum(), ops)]
    ops = [t.requires_grad_() for t in _torch(p, names)]
    out = tfb.fused_swin_block_train(*ops, s1, s2, NH, HD, 8, 1e-5, shift=shift)
    whole = [out.detach(), *torch.autograd.grad(out.square().sum(), ops)]
    for name, a, b in zip(("out", *names), halves, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5, err_msg=name)


def test_gate_and_plan():
    """`attn_block_train_fits` takes SwinIR-M's and SRFormerV2's training
    blocks and refuses other windows, heads of more than 32 channels, rows
    the engine's per-token kernels do not take and a P of 2^31 entries or
    more; the saved-P backward's attention stage at 12x12 windows, the
    saved-P form of the tensor-core window attention, takes 91,584 bytes,
    under the engine's per-token kernels that it shares with #6 (the LN1
    backward's over the C 240 row)."""
    fits = tfb.attn_block_train_fits
    assert fits(64, 64, 8, 180, 6, batch=8)
    assert fits(72, 72, 12, 240, 8, batch=8)
    for ws in (7, 10, 16):
        assert not fits(ws * 8, ws * 8, ws, 180, 6)
    assert not fits(64, 64, 8, 198, 6)  # heads of 33
    assert not fits(72, 72, 12, 264, 8)
    assert not fits(64, 64, 8, 288, 12)  # heads of 24, but rows of 288 channels
    assert not fits(64, 64, 8, 90, 3)  # rows of 90 channels: not 16-byte rows
    # P of B * H * W * heads * n floats: 2^31 at B 4, 1024x1024, 8 heads of 64 tokens
    assert fits(1024, 1024, 8, 240, 8, batch=3)
    assert not fits(1024, 1024, 8, 240, 8, batch=4)
    # the saved-P form of the tensor-core window attention at n 144 (rows of
    # 48, two key parts): k, v (144, 36); q, dA, dq (48, 36); the (48, 148)
    # P / dS tile; one (2, 48) exchange; the 144 token indices
    saved = 2 * 144 * 36 + 3 * 48 * 36 + 48 * 148 + 2 * 48 + 144
    assert 4 * saved == 91_584 == tfb.attn_bwd_tc_smem_bytes(144, att=False, saved=True)
    assert tfb.attn_train_bwd_smem_bytes(240, 8, 12) == max(
        tfb.linear_smem_bytes(), tfb.rows_smem_bytes(240), 4 * saved) == 221_248
    assert tfb.attn_train_bwd_smem_bytes(240, 8, 12) <= tfb.attn_staged_bwd_smem_bytes(240, 8, 12)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU the wrappers check before they launch: a tensor that is
    not on CUDA is refused, never run on the plain version."""
    p, _ = _inputs(8, 1, 50)
    meta = [torch.from_numpy(p[k]).to("meta") for k in (*ATTN, "bias", "s")]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfb.fused_attn_block_train(*meta, NH, HD, 8)
    x, s = meta[0], meta[-1]
    P = torch.empty(2, 2, 2, NH, 64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfb.fused_attn_block_train_backward(*meta[:7], s, P, x, x, 1, NH, HD, 8)
    with pytest.raises(ValueError, match="bias kinds"):
        tfb.fused_attn_block_train_backward(*meta[:7], s, P, x, x, 2, NH, HD, 8)
