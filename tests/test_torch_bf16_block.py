"""The whole-block training Function (TPU kernels #4 and #5) in bf16 on the
CPU, where it runs its bf16 plain versions, against the JAX package's
`fused_swin_block_train` on a bf16 x (its Pallas kernels in interpret mode,
computing in x.dtype) through `jax.vjp`: K=1 unshifted, and K=4 shifted by
4 (JAX's rolls around the kernel against the port's in-kernel shift).

Inputs from a numpy seed: B=2, 16x16, C=32 (2 heads of 16), hidden 64,
window 8, DropPath scales s = [1.0, 0.8]; x and dout rounded to bf16, the
parameters fp32 (the JAX wrapper and the port both cast the weights to
bf16). Tolerances, for arithmetic that rounds to bf16 (8 bits, 2^-8 = 3.9e-3
relative) at the same points in both packages, whose fp32 steps sum in
other orders and whose XLA CPU lowering may keep a bf16 operation's fp32
result where the kernel writes a rounding: `out` within 2^-6 (1.6e-2) of
its largest magnitude, about four bf16 steps, at most one element in a
thousand beyond 2^-8 of it; dx and each fp32 parameter gradient within
1.5e-2 of its tensor's largest magnitude (the gradients sum bf16-rounded
operands over the tokens). P, att and z, which the Function keeps, are held
against the JAX forward's saved ones in the same way.
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

B, HH, WW, NH, HD, WS, HIDDEN = 2, 16, 16, 2, 16, 8, 64
C, N = NH * HD, WS * WS
S = np.asarray([1.0, 0.8], np.float32)
NAMES = ("x", "g1", "be1", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2", "b2")
OUT_TOL = 2.0**-6  # of the largest |out|, about four bf16 steps
OUT_FAR = 2.0**-8  # one bf16 step of the largest |out| ...
OUT_FAR_SHARE = 1e-3  # ... which at most this share of the elements exceed
GRAD_TOL = 1.5e-2  # of each gradient tensor's largest magnitude


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (as float32)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(seed: int, kinds: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    rel = normal(NH, N, N, scale=0.3)
    masks = shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0
    return {
        "x": _bf16(normal(B, HH, WW, C)),
        "g1": 1.0 + normal(C, scale=0.1), "be1": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=C**-0.5), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=C**-0.5), "bp": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(rel[None] + masks, dtype=np.float32),
        "g2": 1.0 + normal(C, scale=0.1), "be2": normal(C, scale=0.1),
        "w1": normal(C, HIDDEN, scale=C**-0.5), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=HIDDEN**-0.5), "b2": normal(C, scale=0.1),
        "dout": _bf16(normal(B, HH, WW, C)),
    }


def _assert_out_close(name: str, got: np.ndarray, want: np.ndarray) -> None:
    top = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= OUT_TOL * top, f"{name}: max|diff| {err.max():.3g} vs max {top:.3g}"
    far = float((err > OUT_FAR * top).mean())
    assert far <= OUT_FAR_SHARE, f"{name}: {far:.3g} of the elements beyond one bf16 step"


def _jax_kinds(kinds: int, shift: int):
    s = jnp.asarray(S)

    def block(*args):
        x, rest = args[0].astype(jnp.bfloat16), args[1:]
        if shift:
            x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        out = jfb.fused_swin_block_train(x, *rest, s, s, NH, HD, WS, 1e-5, True)
        return jnp.roll(out, (shift, shift), axis=(1, 2)) if shift else out

    return block


@pytest.mark.parametrize("kinds", [1, 4])
def test_bf16_train_block_matches_jax_vjp(kinds):
    p = _inputs(30 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    want_out, vjp = jax.vjp(_jax_kinds(kinds, shift), *(jnp.asarray(p[k]) for k in NAMES))
    assert want_out.dtype == jnp.bfloat16
    want = dict(zip(NAMES, (np.asarray(g, np.float32)
                            for g in vjp(jnp.asarray(p["dout"], jnp.bfloat16)))))

    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in NAMES if k != "x"}
    ts["x"] = torch.from_numpy(p["x"]).bfloat16().requires_grad_()
    st = torch.from_numpy(S)
    launches = (tfb.fused_swin_block_train_bf16.launches,
                tfb.fused_swin_block_train_backward_bf16.launches)
    out = tfb.fused_swin_block_train(*(ts[k] for k in NAMES), st, st, NH, HD, WS, 1e-5,
                                     shift=shift)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(p["dout"]).bfloat16())
    # CPU tensors: the plain versions, no kernel launch counted
    assert launches == (tfb.fused_swin_block_train_bf16.launches,
                        tfb.fused_swin_block_train_backward_bf16.launches)
    _assert_out_close("out", out.detach().float().numpy(), np.asarray(want_out, np.float32))
    assert ts["x"].grad.dtype == torch.bfloat16
    assert all(ts[k].grad.dtype == torch.float32 for k in NAMES if k != "x")
    for name, w in want.items():
        g = ts[name].grad.float().numpy()
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= GRAD_TOL * top, f"{name}: max|diff| {err:.3g} vs max|g| {top:.3g}"


@pytest.mark.parametrize("kinds", [1, 4])
def test_bf16_saved_tensors_match_the_jax_forward(kinds):
    """P (the JAX kernel saves it transposed, in the rolled frame), att and
    z in bf16, against the JAX forward's own."""
    p = _inputs(40 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    s = jnp.asarray(S)
    xj = jnp.asarray(p["x"], jnp.bfloat16)
    if shift:
        xj = jnp.roll(xj, (-shift, -shift), axis=(1, 2))
    _, jp, jatt, jz = jfb._swin_block_fwd_impl(
        xj, *(jnp.asarray(p[k]) for k in NAMES[1:]), s, s, NH, HD, WS, 1e-5, True)
    assert jp.dtype == jnp.bfloat16

    def unroll(a):
        a = np.asarray(a, np.float32)
        return np.roll(a, (shift, shift), axis=(1, 2)) if shift else a

    _, P, att, z = tfb.fused_swin_block_train_bf16_reference(
        torch.from_numpy(p["x"]).bfloat16(), *(torch.from_numpy(p[k]) for k in NAMES[1:]),
        torch.from_numpy(S), torch.from_numpy(S), NH, HD, WS, 1e-5, shift)
    assert P.dtype == att.dtype == z.dtype == torch.bfloat16
    _assert_out_close("P", P.float().numpy(), np.swapaxes(np.asarray(jp, np.float32), -1, -2))
    _assert_out_close("att", att.float().numpy(), unroll(jatt))
    _assert_out_close("z", z.float().numpy(), unroll(jz))
