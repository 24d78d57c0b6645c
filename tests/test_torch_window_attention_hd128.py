"""The window attention (TPU kernels #3 and #8) at heads of 65 to 128
channels (the kernels' 128-wide form, DRCT's heads of 122 and 77), on the
CPU, where the port's wrappers run their plain versions:

- the plain versions against the JAX package's Pallas kernels in interpret
  mode through `jax.vjp`, at heads of 122 and 77 at 16x16 windows (B=1,
  32x32, 2 heads) and of 122 at 8x8 (B=1, 16x16, 2 heads), K=1 unshifted
  and K=4 with the shift masks: in fp32 the output and dqkv / dbias within
  1e-4 of each largest; in bf16 (qkv and dout rounded to bf16, the kind
  table fp32; heads of 122 at K=4, of 77 at K=1) by
  tests/test_torch_bf16_window_mlp.py's rule;
- the gates: `window_mhsa_fits` and `rect_mhsa_fits` take heads of 65 to
  128 channels and not 129, on the 128-wide plans (`TC_ATTN_PLANS_128`:
  one (n, 68) room for a half of k or v), while `heads_fit`, the block
  kernels' gate, stays at 32;
- the routing: every preset the port had before this form has heads of at
  most 64 channels (SRFormer's here; the others in
  tests/test_torch_window_attention_hd64.py), so none changes branch; every
  attention of `drct`, `drct_l` and `drct_xl` (heads of 30, 53, 122, 46
  and 77) takes the kernels at the templates' 48x48 crops and at a 128x128
  image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_window_mlp import _assert_grad_close, _assert_out_close, _bf16
from tests.test_torch_window_attention_hd64 import _head_dims
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import window_attention as twa

TOL = 1e-4  # of each tensor's largest magnitude
NH = 2
# (window size, head dim) -> (B, H, W)
CASES = {(16, 122): (1, 32, 32), (16, 77): (1, 32, 32), (8, 122): (1, 16, 16)}


def _inputs(ws: int, hd: int, kinds: int, bf16: bool):
    b, hh, ww = CASES[ws, hd]
    rng = np.random.default_rng(ws * 1000 + hd + kinds)
    c = NH * hd
    qkv = rng.standard_normal((b, hh, ww, 3 * c)).astype(np.float32)
    rel = (rng.standard_normal((NH, ws * ws, ws * ws)) * 0.3).astype(np.float32)
    masks = jwa.shift_mask_kinds(ws, ws // 2)[:, None] if kinds == 4 else 0.0
    bias = np.ascontiguousarray(rel[None] + masks, dtype=np.float32)
    dout = rng.standard_normal((b, hh, ww, c)).astype(np.float32)
    if bf16:
        qkv, dout = _bf16(qkv), _bf16(dout)
    return qkv, bias, dout


@pytest.mark.parametrize(("ws", "hd", "kinds", "dtype"), [
    *((ws, hd, kinds, "fp32") for ws, hd in CASES for kinds in (1, 4)),
    (16, 122, 4, "bf16"), (16, 77, 1, "bf16")])
def test_hd128_plain_versions_match_jax_vjp(ws, hd, kinds, dtype):
    bf16 = dtype == "bf16"
    qkv, bias, dout = _inputs(ws, hd, kinds, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want, vjp = jax.vjp(lambda q, t: jwa.fused_window_mhsa(q, t, NH, hd, ws, True),
                        jnp.asarray(qkv, jdt), jnp.asarray(bias))
    want_dqkv, want_dbias = (np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, jdt)))
    want = np.asarray(want, np.float32)

    tdt = torch.bfloat16 if bf16 else torch.float32
    tq = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    assert twa.window_mhsa_fits(*qkv.shape[1:3], ws, NH * hd, NH) and twa.head_width(hd) == 128
    counted = (twa.fused_window_mhsa, twa.fused_window_mhsa_backward,
               twa.fused_window_mhsa_bf16, twa.fused_window_mhsa_backward_bf16)
    launches = [(f.launches, f.launches_hd128) for f in counted]
    out = twa.fused_window_mhsa(tq, tb, NH, hd, ws)
    out.backward(torch.from_numpy(dout).to(tdt))
    # CPU: the plain versions, uncounted
    assert launches == [(f.launches, f.launches_hd128) for f in counted]
    assert out.dtype == tq.grad.dtype == tdt and tb.grad.dtype == torch.float32
    got = (out.detach().float().numpy(), tq.grad.float().numpy(), tb.grad.numpy())
    if bf16:
        _assert_out_close("out", got[0], want)
        _assert_grad_close("dqkv", got[1], want_dqkv)
        _assert_grad_close("dbias", got[2], want_dbias)
        return
    for name, g, w in zip(("out", "dqkv", "dbias"), got, (want, want_dqkv, want_dbias)):
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= TOL * top, f"{name}: max|diff| {err:.3g} vs max {top:.3g}"


def test_gates_take_heads_of_up_to_128():
    for hd in list(range(60, 70)) + list(range(120, 134)):
        c = 2 * hd
        assert twa.window_mhsa_fits(48, 48, 16, c, 2) == (hd <= 128), hd
        assert twa.window_mhsa_fits(64, 64, 8, c, 2) == (hd <= 128), hd
        for window in ((8, 32), (32, 8), (8, 16), (16, 8)):
            assert twa.rect_mhsa_fits(64, 64, *window, c, 2) == (hd <= 128), (hd, window)
        assert not twa.heads_fit(8, c, 2)  # the block kernels keep 32
        assert twa.head_width(hd) == (64 if hd <= 64 else 128 if hd <= 128 else twa.HD_MAX)
    assert twa.fused_window_mhsa_supported(48, 48, 16, 244, 2)  # drct's swin_3
    assert twa.fused_window_mhsa_supported(48, 48, 16, 308, 4)  # drct's swin_5


def test_hd128_plans():
    """The 128-wide plans: one (n, 68) room for a half of k or v (a whole
    128-wide head's k and v would need 270,336 B at n 256); the forward on
    rows of 64 in two key parts (173,056 B at n 256), the backward on the
    64-wide plans (rows of 32 in four parts: 131,584 B); the 32- and 64-wide
    plans unchanged."""
    assert 4 * 2 * 256 * (128 + 4) == 270_336 > twa.SMEM_LIMIT
    assert twa.tc_attn_plan(256, 122) == twa.tc_attn_plan(64, 77) == (64, 2)
    assert twa.tc_attn_plan(256, 122, backward=True) == twa.tc_attn_plan(256, 35) == (32, 4)
    assert twa.tc_attn_plan(256, 30) == (64, 4)
    assert twa.window_mhsa_smem_bytes(244, 2, 16) == 173_056
    assert twa.window_mhsa_bwd_smem_bytes(244, 2, 16) == 131_584
    assert twa.window_mhsa_smem_bytes(210, 6, 16) == 192_000  # ATD's, as before
    assert twa.window_mhsa_smem_bytes(180, 6, 16) == 161_792  # HAT-M's, as before
    for n in (64, 128, 256):
        assert max(twa.attn_fwd_tc_smem_bytes(n, 122),
                   twa.attn_bwd_tc_smem_bytes(n, att=False, head_dim=77)) <= twa.SMEM_LIMIT


@pytest.mark.parametrize("preset", ["srformer", "srformer_light"])
def test_routing_of_the_ported_presets_is_unchanged(preset):
    """Only heads of 65 to 128 channels see the wider gate: no preset ported
    before has them (the presets before ATD and ATD's own are held by
    tests/test_torch_window_attention_hd64.py's routing test, at most 32 and
    35 channels; SRFormer's here)."""
    dims = _head_dims(preset)
    assert dims and max(dims) <= 64, (preset, dims)


@pytest.mark.parametrize("preset", ["drct", "drct_l", "drct_xl"])
def test_drct_attentions_take_the_kernels(preset):
    dims = _head_dims(preset)
    assert dims == {30, 53, 122, 46, 77}
    for c, nh in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        assert twa.fused_window_mhsa_supported(48, 48, 16, c, nh)
        assert twa.fused_window_mhsa_supported(128, 128, 16, c, nh)
