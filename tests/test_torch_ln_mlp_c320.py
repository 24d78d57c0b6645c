"""The MLP half (TPU kernels #2 and #7) at rows of 257-320 channels (DRCT's
swin_4 and swin_5 blocks: C 276 and 308, hidden = C), on the CPU, where the
port's wrappers run their plain versions, against the JAX package's Pallas
kernels in interpret mode through `jax.vjp`:

- fp32 (B=1, 16x16, rows 16, DropPath scale 0.8): the output within 1e-4 of
  its largest, each gradient (dx, dg, dbe, dw1, db1, dw2, db2) within 1e-4
  of its tensor's largest;
- bf16 (x and dout rounded to bf16, fp32 parameters) by
  tests/test_torch_bf16_window_mlp.py's rule;
- the gates: `ln_mlp_bwd_fits` takes rows of up to 320 channels (the split
  rows stage past 256, its products 160 columns wide) and not 324, and
  DRCT's five MLP halves train on the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_window_mlp import _assert_grad_close, _assert_out_close, _bf16
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu_torch.ops import fused_block as tfb

TOL = 1e-4  # of each tensor's largest magnitude
NAMES = ("x", "g", "be", "w1", "b1", "w2", "b2")
ROWS = 16


def _inputs(c: int, bf16: bool) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(c)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"x": normal(1, 16, 16, c), "g": 1.0 + normal(c, scale=0.1), "be": normal(c, scale=0.1),
         "w1": normal(c, c, scale=c**-0.5), "b1": normal(c, scale=0.1),
         "w2": normal(c, c, scale=c**-0.5), "b2": normal(c, scale=0.1),
         "dout": normal(1, 16, 16, c)}
    if bf16:
        p["x"], p["dout"] = _bf16(p["x"]), _bf16(p["dout"])
    return p


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("c", [276, 308])
def test_c320_plain_versions_match_jax_vjp(c, dtype):
    bf16 = dtype == "bf16"
    p = _inputs(c, bf16)
    s = np.asarray([0.8], np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def jfn(x, *rest):
        return jfb.fused_ln_mlp(x.astype(jdt), *rest, jnp.asarray(s), ROWS, 1e-5, True)

    want_out, vjp = jax.vjp(jfn, *(jnp.asarray(p[k]) for k in NAMES))
    want = dict(zip(NAMES, (np.asarray(g, np.float32)
                            for g in vjp(jnp.asarray(p["dout"], jdt)))))
    want_out = np.asarray(want_out, np.float32)

    tdt = torch.bfloat16 if bf16 else torch.float32
    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in NAMES if k != "x"}
    ts["x"] = torch.from_numpy(p["x"]).to(tdt).requires_grad_()
    assert tfb.fused_mlp_supported(16, 16, ROWS, c, c, train=True)
    counted = (tfb.fused_ln_mlp_backward, tfb.fused_ln_mlp_backward_bf16)
    launches = [(f.launches, f.launches_c320) for f in counted]
    out = tfb.fused_ln_mlp(*(ts[k] for k in NAMES), torch.from_numpy(s), ROWS)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(p["dout"]).to(tdt))
    # CPU: the plain versions, uncounted
    assert launches == [(f.launches, f.launches_c320) for f in counted]
    got_out = out.detach().float().numpy()
    if bf16:
        _assert_out_close("out", got_out, want_out)
    else:
        err, top = np.abs(got_out - want_out).max(), np.abs(want_out).max()
        assert err <= TOL * top, f"out: {err:.3g} vs {top:.3g}"
    for name in NAMES:
        g = ts[name].grad
        assert g.dtype == (tdt if name == "x" else torch.float32), name
        g = g.float().numpy()
        if bf16:
            _assert_grad_close(name, g, want[name])
        else:
            err, top = np.abs(g - want[name]).max(), np.abs(want[name]).max()
            assert err <= TOL * top, f"{name}: {err:.3g} vs {top:.3g}"


def test_c320_gates(monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    for c in range(4, 340, 4):
        assert tfb.ln_mlp_bwd_fits(c, c) == (c <= tfb.MLP_ROWS_MAX_C == 320), c
    assert not tfb.ln_mlp_bwd_fits(306, 306)  # rows move in 16-byte pieces
    assert tfb.tc_rows_fit(256) and not tfb.tc_rows_fit(260)  # the attention halves keep 256
    for c, hidden in ((180, 360), (212, 424), (244, 488), (276, 276), (308, 308)):
        assert tfb.fused_mlp_supported(48, 48, 16, c, hidden, train=True), c
        assert tfb.fused_mlp_supported(128, 128, 16, c, hidden), c
