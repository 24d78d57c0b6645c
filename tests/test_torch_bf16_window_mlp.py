"""The bf16 forms of the window attention (TPU kernels #3 and #8) and of the
MLP half (#2 and #7) on the CPU, where the port's wrappers run their bf16
plain versions, against the JAX package's Pallas kernels on bf16 inputs in
interpret mode (computing in the input's dtype) through `jax.vjp`.

- #3/#8 through `fused_window_mhsa` at 8x8 windows (B=2, 16x24, 2 heads of
  12: heads that pad to 16 channels) and 16x16 (B=1, 32x32, 2 heads of 12),
  and through `fused_rect_mhsa` at DAT's 8x16 and 32x8 windows (B=1, 32x32,
  2 heads of 12), each K=1 unshifted and K=4 with the shift masks: qkv and
  dout rounded to bf16, the kind table fp32; out, dqkv in bf16, dbias fp32.
- #2/#7 through `fused_ln_mlp` (B=2, 16x16, C 32, hidden 64, DropPath
  scales [1.0, 0.8]) on a bf16 x with fp32 parameters.

Tolerances are those of #4/#5's bf16 forms (tests/test_torch_bf16_block.py), for
arithmetic that rounds to bf16 (2^-8 = 3.9e-3 relative) at the same points
in both packages, whose fp32 steps sum in other orders and whose XLA CPU
lowering may keep an fp32 result where the kernel writes a rounding: every
output within 2^-6 of its largest magnitude, at most one element in a
thousand beyond 2^-8 of it; each gradient within 1.5e-2 of its tensor's
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import fused_block as tfb
from trainner_redux_tpu_torch.ops import window_attention as twa

OUT_TOL = 2.0**-6  # of the largest |out|, about four bf16 steps
OUT_FAR = 2.0**-8  # one bf16 step of the largest |out| ...
OUT_FAR_SHARE = 1e-3  # ... which at most this share of the elements exceed
GRAD_TOL = 1.5e-2  # of each gradient tensor's largest magnitude
NH, HD = 2, 12
C = NH * HD

# window (rows, columns) -> (B, H, W) of its case
WINDOWS = {(8, 8): (2, 16, 24), (16, 16): (1, 32, 32), (8, 16): (1, 32, 32),
           (32, 8): (1, 32, 32)}


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (as float32)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _assert_out_close(name: str, got: np.ndarray, want: np.ndarray) -> None:
    top = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= OUT_TOL * top, f"{name}: max|diff| {err.max():.3g} vs max {top:.3g}"
    far = float((err > OUT_FAR * top).mean())
    assert far <= OUT_FAR_SHARE, f"{name}: {far:.3g} of the elements beyond one bf16 step"


def _assert_grad_close(name: str, got: np.ndarray, want: np.ndarray) -> None:
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= GRAD_TOL * top, f"{name}: max|diff| {err:.3g} vs max|g| {top:.3g}"


def _window_inputs(window, kinds: int):
    wr, wc = window
    b, hh, ww = WINDOWS[window]
    rng = np.random.default_rng(wr * 100 + wc + kinds)
    qkv = _bf16(rng.standard_normal((b, hh, ww, 3 * C)).astype(np.float32))
    rel = (rng.standard_normal((NH, wr * wc, wr * wc)) * 0.3).astype(np.float32)
    masks = jwa.rect_shift_mask_kinds(wr, wc, wr // 2, wc // 2)[:, None] if kinds == 4 else 0.0
    bias = np.ascontiguousarray(rel[None] + masks, dtype=np.float32)
    dout = _bf16(rng.standard_normal((b, hh, ww, C)).astype(np.float32))
    return qkv, bias, dout


@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_bf16_window_attention_matches_jax_vjp(window, kinds):
    wr, wc = window
    qkv, bias, dout = _window_inputs(window, kinds)
    if wr == wc:
        def jfn(q, b):
            return jwa.fused_window_mhsa(q, b, NH, HD, wr, True)

        def tfn(q, b):
            return twa.fused_window_mhsa(q, b, NH, HD, wr)
        counted = (twa.fused_window_mhsa_bf16, twa.fused_window_mhsa_backward_bf16)
    else:
        def jfn(q, b):
            return jwa.fused_rect_mhsa(q, b, NH, HD, wr, wc, True)

        def tfn(q, b):
            return twa.fused_rect_mhsa(q, b, NH, HD, wr, wc)
        counted = (twa.fused_rect_mhsa_bf16, twa.fused_rect_mhsa_backward_bf16)
    want, vjp = jax.vjp(jfn, jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias))
    assert want.dtype == jnp.bfloat16
    want_dqkv, want_dbias = vjp(jnp.asarray(dout, jnp.bfloat16))

    tq = torch.from_numpy(qkv).bfloat16().requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    launches = [f.launches for f in counted]
    out = tfn(tq, tb)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(dout).bfloat16())
    assert launches == [f.launches for f in counted]  # CPU: the plain versions, uncounted
    assert tq.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.float32
    _assert_out_close("out", out.detach().float().numpy(), np.asarray(want, np.float32))
    _assert_grad_close("dqkv", tq.grad.float().numpy(), np.asarray(want_dqkv, np.float32))
    _assert_grad_close("dbias", tb.grad.numpy(), np.asarray(want_dbias, np.float32))


def test_bf16_window_attention_plain_versions_dispatch():
    """A bf16 qkv takes the bf16 forms: the plain versions' roundings (P and
    the outputs to bf16), not the fp32 reference's."""
    qkv, bias, dout = _window_inputs((8, 8), 4)
    q = torch.from_numpy(qkv).bfloat16()
    b, d = torch.from_numpy(bias), torch.from_numpy(dout).bfloat16()
    out = twa.fused_window_mhsa(q, b, NH, HD, 8)
    torch.testing.assert_close(out, twa.fused_window_mhsa_bf16_reference(q, b, NH, HD, 8),
                               rtol=0, atol=0)
    fp32 = twa.fused_window_mhsa_reference(q.float(), b, NH, HD, 8)
    assert not torch.equal(out.float(), fp32)
    got = twa.fused_window_mhsa_backward(q, b, d, NH, HD, 8)
    want = twa.fused_window_mhsa_bwd_bf16_reference(q, b, d, NH, HD, 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


MLP_B, MLP_H, MLP_C, MLP_HIDDEN, MLP_ROWS = 2, 16, 32, 64, 8
MLP_NAMES = ("x", "g", "be", "w1", "b1", "w2", "b2")
MLP_S = np.asarray([1.0, 0.8], np.float32)


def _mlp_inputs(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c, hid = MLP_C, MLP_HIDDEN
    return {
        "x": _bf16(normal(MLP_B, MLP_H, MLP_H, c)),
        "g": 1.0 + normal(c, scale=0.1), "be": normal(c, scale=0.1),
        "w1": normal(c, hid, scale=c**-0.5), "b1": normal(hid, scale=0.1),
        "w2": normal(hid, c, scale=hid**-0.5), "b2": normal(c, scale=0.1),
        "dout": _bf16(normal(MLP_B, MLP_H, MLP_H, c)),
    }


def test_bf16_ln_mlp_matches_jax_vjp():
    p = _mlp_inputs(7)
    s = jnp.asarray(MLP_S)

    def jfn(x, *rest):
        return jfb.fused_ln_mlp(x.astype(jnp.bfloat16), *rest, s, MLP_ROWS, 1e-5, True)

    want_out, vjp = jax.vjp(jfn, *(jnp.asarray(p[k]) for k in MLP_NAMES))
    assert want_out.dtype == jnp.bfloat16
    want = dict(zip(MLP_NAMES, (np.asarray(g, np.float32)
                                for g in vjp(jnp.asarray(p["dout"], jnp.bfloat16)))))

    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in MLP_NAMES if k != "x"}
    ts["x"] = torch.from_numpy(p["x"]).bfloat16().requires_grad_()
    launches = (tfb.fused_ln_mlp_bf16.launches, tfb.fused_ln_mlp_backward_bf16.launches)
    out = tfb.fused_ln_mlp(*(ts[k] for k in MLP_NAMES), torch.from_numpy(MLP_S), MLP_ROWS)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(p["dout"]).bfloat16())
    assert launches == (tfb.fused_ln_mlp_bf16.launches, tfb.fused_ln_mlp_backward_bf16.launches)
    _assert_out_close("out", out.detach().float().numpy(), np.asarray(want_out, np.float32))
    assert ts["x"].grad.dtype == torch.bfloat16
    for name in MLP_NAMES:
        g = ts[name].grad
        assert g.dtype == (torch.bfloat16 if name == "x" else torch.float32), name
        _assert_grad_close(name, g.float().numpy(), want[name])


def test_bf16_ln_mlp_limits():
    """The bf16 MLP forms take the rows the fp32 backward takes: at most 320
    channels (one rows tile up to 256, the split rows stage past it), C and
    hidden multiples of 4: HAT's C 144 and 180, SRFormerV2's C 240 / hidden
    480 and DRCT's C 276 and 308; wider or ragged rows are refused (the
    wrappers raise on them on the card), never run in fp32."""
    assert tfb.ln_mlp_bwd_fits(180, 360) and tfb.ln_mlp_bwd_fits(144, 288)
    assert tfb.ln_mlp_bwd_fits(240, 480)
    assert tfb.ln_mlp_bwd_fits(260, 520) and tfb.ln_mlp_bwd_fits(308, 308)
    assert not tfb.ln_mlp_bwd_fits(324, 324)
    assert not tfb.ln_mlp_bwd_fits(182, 360)
    assert not tfb.ln_mlp_bwd_fits(180, 362)
