"""The port's whole-block training Function (TPU kernels #4 and #5) on the
CPU, where it runs its plain versions:

- against the JAX package's `fused_swin_block_train` through `jax.vjp`,
  its Pallas kernels in interpret mode: K=1 unshifted, and K=4 with JAX's
  rolls around the kernel against the port's in-kernel shift;
- the plain saved-P backward against torch.autograd of the plain forward.

Same inputs from a numpy seed: B=2, 16x24, C=24 (3 heads of 8), hidden 48,
window 8, DropPath scales s = [1.0, 0.8]. Tolerances: `out` within 3e-5
(that of the JAX package's own fused-block tests; the TPU kernel takes an
A&S erf and a tile-wide softmax max), each gradient within 1e-4 of its
tensor's largest magnitude.
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
NAMES = ("x", "g1", "be1", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2", "b2")


def _inputs(seed: int, kinds: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    rel = normal(NH, N, N, scale=0.3)
    masks = shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0
    return {
        "x": normal(B, HH, WW, C),
        "g1": 1.0 + normal(C, scale=0.1), "be1": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=0.2), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=0.2), "bp": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(rel[None] + masks, dtype=np.float32),
        "g2": 1.0 + normal(C, scale=0.1), "be2": normal(C, scale=0.1),
        "w1": normal(C, HIDDEN, scale=0.2), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=0.2), "b2": normal(C, scale=0.1),
        "dout": normal(B, HH, WW, C),
    }


def _assert_grads_close(got: dict, want: dict, rel: float = 1e-4) -> None:
    for name, w in want.items():
        g = np.asarray(got[name])
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        top = np.abs(w).max()
        assert err <= rel * top, f"{name}: max|diff| {err:.3g} vs max|g| {top:.3g}"


@pytest.mark.parametrize("kinds", [1, 4])
def test_train_block_matches_jax_vjp(kinds):
    p = _inputs(10 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    s = jnp.asarray(S)

    def jax_block(*args):
        x, rest = args[0], args[1:]
        if shift:
            x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        out = jfb.fused_swin_block_train(x, *rest, s, s, NH, HD, WS, 1e-5, True)
        return jnp.roll(out, (shift, shift), axis=(1, 2)) if shift else out

    want_out, vjp = jax.vjp(jax_block, *(jnp.asarray(p[k]) for k in NAMES))
    want = dict(zip(NAMES, (np.asarray(g) for g in vjp(jnp.asarray(p["dout"])))))

    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in NAMES}
    st = torch.from_numpy(S)
    launches = (tfb.fused_swin_block_train.launches,
                tfb.fused_swin_block_train_backward.launches)
    out = tfb.fused_swin_block_train(*(ts[k] for k in NAMES), st, st, NH, HD, WS, 1e-5,
                                     shift=shift)
    out.backward(torch.from_numpy(p["dout"]))
    # CPU tensors: the plain versions, no kernel launch counted
    assert launches == (tfb.fused_swin_block_train.launches,
                        tfb.fused_swin_block_train_backward.launches)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=3e-5, rtol=0)
    _assert_grads_close({k: t.grad.numpy() for k, t in ts.items()}, want)


@pytest.mark.parametrize("kinds", [1, 4])
def test_plain_backward_matches_autograd(kinds):
    p = _inputs(20 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in NAMES}
    st = torch.from_numpy(S)
    out, P, att, z = tfb.fused_swin_block_train_reference(
        *(ts[k] for k in NAMES), st, st, NH, HD, WS, 1e-5, shift)
    assert P.shape == (B, HH // WS, WW // WS, NH, N, N)
    dout = torch.from_numpy(p["dout"])
    want = torch.autograd.grad(out, [ts[k] for k in NAMES], dout)
    plain = {k: t.detach() for k, t in ts.items()}
    got = tfb.fused_swin_block_train_bwd_reference(
        *(plain[k] for k in NAMES if k != "bias"), st, st, P.detach(), att.detach(),
        z.detach(), dout, kinds, NH, HD, WS, 1e-5, shift)
    order = [k for k in NAMES if k != "bias"]
    order.insert(7, "bias")
    _assert_grads_close(dict(zip(order, got)),
                        {k: g.numpy() for k, g in zip(NAMES, want)})
