"""The window attention (TPU kernels #3 and #8) at heads of 33 to 64
channels, on the CPU, where the port's wrappers run their plain versions:

- the plain versions against the JAX package's Pallas kernels in interpret
  mode through `jax.vjp`, at heads of 35 (ATD's) and 64 at 8x8 windows (B=1,
  16x16, 2 heads) and of 35 at 16x16 (B=1, 32x32, 2 heads), K=1 unshifted
  and K=4 with the shift masks: in fp32 the output and dqkv / dbias within
  1e-4 of each largest; in bf16 (qkv and dout rounded to bf16, the kind table
  fp32; heads of 64 at K=4, of 35 at 16x16 K=1 and K=4) by
  tests/test_torch_bf16_window_mlp.py's rule;
- the gates: `window_mhsa_fits` and `rect_mhsa_fits` take heads of up to 64
  channels and not 65, at shared-memory plans computed from the head
  width (`TC_ATTN_PLANS_64`), while `heads_fit`, the block kernels' gate,
  stays at 32;
- the routing: every transformer preset the port had before (SwinIR, HAT,
  DAT, Swin2SR, SRFormerV2) has heads of at most 32 channels, so the wider
  gate changes none of their branches; `atd`'s window attention (heads of
  35) now takes the kernels, `atd_light`'s (heads of 8) took them before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_window_mlp import _assert_grad_close, _assert_out_close, _bf16
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import window_attention as twa

TOL = 1e-4  # of each tensor's largest magnitude
NH = 2
# (window size, head dim) -> (B, H, W)
CASES = {(8, 35): (1, 16, 16), (8, 64): (1, 16, 16), (16, 35): (1, 32, 32)}


def _inputs(ws: int, hd: int, kinds: int, bf16: bool):
    b, hh, ww = CASES[ws, hd]
    rng = np.random.default_rng(ws * 100 + hd + kinds)
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
    (8, 64, 4, "bf16"), (16, 35, 1, "bf16"), (16, 35, 4, "bf16")])
def test_hd64_plain_versions_match_jax_vjp(ws, hd, kinds, dtype):
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
    assert twa.window_mhsa_fits(*qkv.shape[1:3], ws, NH * hd, NH)
    counted = (twa.fused_window_mhsa, twa.fused_window_mhsa_backward,
               twa.fused_window_mhsa_bf16, twa.fused_window_mhsa_backward_bf16)
    launches = [f.launches for f in counted]
    out = twa.fused_window_mhsa(tq, tb, NH, hd, ws)
    out.backward(torch.from_numpy(dout).to(tdt))
    assert launches == [f.launches for f in counted]  # CPU: the plain versions, uncounted
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


def test_gates_take_heads_of_up_to_64():
    for hd in range(1, 70):
        c = 6 * hd
        assert twa.window_mhsa_fits(48, 48, 16, c, 6) == (hd <= 64), hd
        assert twa.window_mhsa_fits(64, 64, 8, c, 6) == (hd <= 64), hd
        for window in ((8, 32), (32, 8), (8, 16), (16, 8)):
            assert twa.rect_mhsa_fits(64, 64, *window, c, 6) == (hd <= 64), (hd, window)
        assert twa.heads_fit(8, c, 6) == (hd <= 32), hd  # the block kernels keep 32
    assert twa.fused_window_mhsa_supported(48, 48, 16, 210, 6)  # atd's training block
    assert twa.head_width(35) == twa.head_width(64) == 64 and twa.head_width(30) == 32


def test_hd64_plans():
    """The 64-wide plans: at n 256 rows of 32 (the 64-row plan would need
    243,712 B, past SMEM_LIMIT), the forward 192,000 B and the backward
    201,216 B; the 32-wide plans unchanged."""
    ld = 68
    assert 4 * (2 * 256 * ld + 2 * 64 * ld + 64 * 260 + 2 * 4 * 64 + 256) == 243_712
    assert twa.tc_attn_plan(256, 35) == (32, 4) and twa.tc_attn_plan(256, 30) == (64, 4)
    assert twa.window_mhsa_smem_bytes(210, 6, 16) == 192_000
    assert twa.window_mhsa_bwd_smem_bytes(210, 6, 16) == 201_216
    assert twa.window_mhsa_smem_bytes(180, 6, 16) == 161_792  # HAT-M's, as before
    for n in (64, 128, 256):
        assert max(twa.attn_fwd_tc_smem_bytes(n, 64),
                   twa.attn_bwd_tc_smem_bytes(n, att=False, head_dim=64)) <= twa.SMEM_LIMIT


# the transformer presets the port had before the 64-wide form
PORTED = ("swinir_s", "swinir_m", "swinir_l", "hat_s", "hat_m", "hat_l", "hat", "dat",
          "dat_2", "dat_s", "dat_light", "swin2sr_s", "swin2sr_m", "swin2sr_l", "srformerv2")


def _head_dims(preset: str) -> set[int]:
    """The head dims of every attention module of the preset (built on the
    meta device: shapes only)."""
    from trainner_redux_tpu_torch.archs import build_network

    with torch.device("meta"):
        net = build_network({"type": preset, "scale": 4})
    dims = set()
    for m in net.modules():
        nh = getattr(m, "num_heads", None)
        dim = getattr(m, "dim", None)
        if isinstance(nh, int) and isinstance(dim, int):
            dims.add(dim // nh)
        elif isinstance(nh, int) and isinstance(getattr(m, "head_dim", None), int):
            dims.add(m.head_dim)
    return dims


@pytest.mark.parametrize("preset", PORTED + ("atd", "atd_light"))
def test_routing_of_the_ported_presets_is_unchanged(preset):
    """Only heads of 33 to 64 channels see the wider gate: no preset ported
    before has them, so each takes the branch it took; atd's window
    attention (35) moves from the plain branch to the kernels."""
    dims = _head_dims(preset)
    assert dims, preset
    if preset == "atd":
        assert dims == {35}
        assert twa.fused_window_mhsa_supported(48, 48, 16, 210, 6)
        assert twa.fused_window_mhsa_supported(128, 128, 16, 210, 6)
    else:
        assert max(dims) <= 32, (preset, dims)
