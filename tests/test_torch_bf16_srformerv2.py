"""bf16 SRFormerV2 on the CPU against the JAX package.

1. The attention half at 12x12 windows in bf16 (TPU kernel #1's bf16 form
   and its recompute backward #6), which the port runs as its plain
   versions on the CPU, against the JAX `fused_attn_block` on a bf16 x (its
   Pallas kernels in interpret mode, computing in x.dtype) through
   `jax.vjp`: K=1 unshifted, K=4 shifted by 6 (JAX rolls around the kernel,
   the port indexes the shift). Inputs from a numpy seed: B=1, 24x24 (2x2
   windows), C 16 (2 heads of 8), DropPath scales [0.8]; x and dout rounded
   to bf16, the parameters fp32. Tolerances as for #2-#5, #7 and #8's bf16
   forms (tests/test_torch_bf16_block.py), for arithmetic that rounds to
   bf16 (2^-8 relative) at the same points in both packages, whose fp32
   steps sum in other orders and whose XLA CPU lowering may keep an fp32
   result where the kernel rounds: z within 2^-6 of its largest magnitude,
   at most one element in a thousand beyond 2^-8 of it; dx and each fp32
   parameter gradient within 1.5e-2 of its tensor's largest magnitude.
2. A tiny SRFormerV2 (tests/test_torch_srformerv2.py's: embed 32, one
   layer of 2 PSA and 3 Swin blocks, 2 heads, window 12, squeeze 8, 2x,
   batch 2 of 24x24 LR) computing in bf16 in training against the flax
   SRFormerV2 built with dtype=bfloat16 (its Swin blocks on the Pallas
   kernels in interpret mode), from equal parameters: the output within
   2e-2 of its largest magnitude (as the other bf16 families'); each
   parameter gradient held against the port's fp32 gradient in L2 (as
   `chip_smoke.py` holds bf16 steps on the card): its distance at most
   twice the flax bf16 gradient's, plus 1e-2 of the fp32 gradient's norm.
   L2 and not the largest element: the port rounds to bf16 after every
   operation of the graph, as the kernels and flax on the chip do, where
   XLA's CPU lowering keeps fp32 between fused operations, so the port's
   gradients lie 1.0-1.7x as far from fp32 as flax's in L2 (measured), and
   a LayerNorm scale's gradient, a sum that nearly cancels, up to 2.6x in
   its largest element. The Swin blocks run the bf16 forms of #1/#6 and
   #2/#7 (their calls counted), PSA and ConvFFN in bf16 in PyTorch.
Two bf16 `SRModel` steps of it against the JAX `SRModel` are in
tests/test_torch_bf16_srformerv2_steps.py (each file near a minute and a
half under the tier-1 run's six workers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block as jfb
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block as tfb

B, HH, WW, NH, HD, WS = 1, 24, 24, 2, 8, 12
C, N = NH * HD, WS * WS
S = np.asarray([0.8], np.float32)
ATTN = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias")
OUT_TOL = 2.0**-6  # of the largest |z|, about four bf16 steps
OUT_FAR = 2.0**-8  # one bf16 step of the largest |z| ...
OUT_FAR_SHARE = 1e-3  # ... which at most this share of the elements exceed
GRAD_TOL = 1.5e-2  # of each gradient tensor's largest magnitude


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(seed: int, kinds: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    rel = normal(NH, N, N, scale=0.3)
    masks = shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0
    return {
        "x": _bf16(normal(B, HH, WW, C)),
        "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "wq": normal(C, 3 * C, scale=C**-0.5), "bq": normal(3 * C, scale=0.1),
        "wp": normal(C, C, scale=C**-0.5), "bp": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(rel[None] + masks, dtype=np.float32),
        "dout": _bf16(normal(B, HH, WW, C)),
    }


def _jax_attn(shift: int):
    s = jnp.asarray(S)

    def f(x, *rest):
        x = x.astype(jnp.bfloat16)
        if shift:
            x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        z = jfb.fused_attn_block(x, *rest, s, NH, HD, WS, 1e-5, True)
        return jnp.roll(z, (shift, shift), axis=(1, 2)) if shift else z

    return f


@pytest.mark.parametrize("kinds", [1, 4])
def test_bf16_attn_half_matches_jax_vjp(kinds):
    p = _inputs(50 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    want_z, vjp = jax.vjp(_jax_attn(shift), *(jnp.asarray(p[k]) for k in ATTN))
    assert want_z.dtype == jnp.bfloat16
    want = dict(zip(ATTN, (np.asarray(g, np.float32)
                           for g in vjp(jnp.asarray(p["dout"], jnp.bfloat16)))))

    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in ATTN if k != "x"}
    ts["x"] = torch.from_numpy(p["x"]).bfloat16().requires_grad_()
    launches = (tfb.fused_attn_block_bf16.launches, tfb.fused_attn_block_backward_bf16.launches,
                tfb.fused_attn_block.launches, tfb.fused_attn_block_backward.launches)
    z = tfb.fused_attn_block(*(ts[k] for k in ATTN), torch.from_numpy(S), NH, HD, WS, 1e-5,
                             shift=shift)
    assert z.dtype == torch.bfloat16
    z.backward(torch.from_numpy(p["dout"]).bfloat16())
    # CPU tensors: the bf16 plain versions, no kernel launch counted
    assert launches == (tfb.fused_attn_block_bf16.launches,
                        tfb.fused_attn_block_backward_bf16.launches,
                        tfb.fused_attn_block.launches, tfb.fused_attn_block_backward.launches)
    got_z, top = z.detach().float().numpy(), np.abs(np.asarray(want_z, np.float32)).max()
    err = np.abs(got_z - np.asarray(want_z, np.float32))
    assert err.max() <= OUT_TOL * top, f"z: max|diff| {err.max():.3g} vs max {top:.3g}"
    assert float((err > OUT_FAR * top).mean()) <= OUT_FAR_SHARE
    assert ts["x"].grad.dtype == torch.bfloat16
    for name, w in want.items():
        g = ts[name].grad.float().numpy()
        assert ts[name].grad.dtype == (torch.bfloat16 if name == "x" else torch.float32)
        gerr, gtop = np.abs(g - w).max(), np.abs(w).max()
        assert gerr <= GRAD_TOL * gtop, f"{name}: max|diff| {gerr:.3g} vs max|g| {gtop:.3g}"


def test_bf16_attn_half_gate_and_plans():
    """The bf16 forms take SRFormerV2's 12x12 blocks (C 240, 8 heads of 30:
    every plan within one thread block's 232,448 bytes, the largest #6's
    window attention over groups of windows, 218,880) and nothing else:
    8x8 windows, heads of 40 channels and rows over 256 channels are out."""
    assert tfb.attn_block_bf16_fits(72, 72, 12, 240, 8)
    assert tfb.attn_block_bf16_smem_bytes(240) == tfb.attn_group_smem_bytes() == 218_880
    assert tfb.attn_block_bf16_smem_bytes(240) <= 232_448
    assert not tfb.attn_block_bf16_fits(64, 64, 8, 180, 6)
    assert not tfb.attn_block_bf16_fits(72, 72, 12, 240, 6)
    assert not tfb.attn_block_bf16_fits(72, 72, 12, 288, 12)
    assert not tfb.attn_block_bf16_fits(66, 72, 12, 240, 8)


SRF_OUT_TOL = 2e-2  # of the largest |output|
GRAD_RATIO, GRAD_SLACK = 2.0, 1e-2  # port's bf16 L2 error <= RATIO x flax's + SLACK x |fp32 g|


def _counting(monkeypatch, module, names):
    """Count the calls of each wrapper `names` of `module` (the Functions
    look them up there), however the launch counters stand."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, counted)
    return calls


BF16_FORMS = ("fused_attn_block_bf16", "fused_attn_block_backward_bf16", "fused_ln_mlp_bf16",
              "fused_ln_mlp_backward_bf16")


def test_bf16_srformerv2_matches_flax(monkeypatch):
    from tests.test_torch_srformerv2 import TINY, _jax_flat
    from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
    from trainner_redux_tpu.models.base_model import BaseModel
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(noise=0.02)
    jnet = jax_build_cast({**TINY, "scale": 2}, jnp.bfloat16)
    rng = np.random.default_rng(4)
    lr = rng.random((2, 24, 24, 3)).astype(np.float32)
    wout = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(lr), train=True)
        return jnp.sum(out * wout), out

    params = BaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want_g = {k: np.asarray(v) for k, v in
              state_dict_from_jax(BaseModel.flatten_params(jgrads), "SRFormerV2").items()}

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    calls = _counting(monkeypatch, tfb, BF16_FORMS)
    nets = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = build_network_cast({**TINY, "scale": 2}, dtype)
        assert net.compute_dtype == dtype and net.bf16_refusal() is None
        net.load_state_dict(state_dict_from_jax(flat, "SRFormerV2"), strict=False)
        net.train()
        out = net(torch.from_numpy(lr).permute(0, 3, 1, 2))
        assert out.dtype == torch.float32
        (out * torch.from_numpy(wout).permute(0, 3, 1, 2)).sum().backward()
        nets[dtype] = (out.detach().permute(0, 2, 3, 1).numpy(),
                       {k: p.grad.numpy() for k, p in net.named_parameters()
                        if p.grad is not None})
    # the three Swin blocks on the bf16 forms, once each way; the fp32 net on none
    assert calls == dict.fromkeys(BF16_FORMS, 3)
    got, got_g = nets[torch.bfloat16]
    want = np.asarray(want)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= SRF_OUT_TOL * top, f"output: max|diff| {err:.3g} vs max {top:.3g}"
    fp32_g = nets[torch.float32][1]
    assert got_g.keys() == fp32_g.keys()
    for k, g in got_g.items():
        assert g.dtype == np.float32, k
        port, flax = (np.linalg.norm(a - fp32_g[k]) for a in (g, want_g[k]))
        top = np.linalg.norm(fp32_g[k])
        assert port <= GRAD_RATIO * flax + GRAD_SLACK * top, (
            f"{k}: bf16 off fp32 by {port:.3g} in L2 (flax bf16 {flax:.3g}) of |g| {top:.3g}")
