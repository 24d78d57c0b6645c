"""bf16 Swin2SR on the CPU against the JAX package.

1. The post-norm SwinV2 halves in bf16 (TPU kernels #11-#14's bf16 forms),
   which the port runs as their plain versions on the CPU, against the JAX
   `fused_cos_attn_block` and `fused_postnorm_mlp` on a bf16 x (their Pallas
   kernels in interpret mode, computing in x.dtype) through `jax.vjp`: the
   attention half K=1 unshifted and K=4 shifted by 4 (JAX rolls around the
   kernel, the port indexes the shift), the MLP half once. Inputs from a
   numpy seed: B=2, 16x16 (2x2 windows), C 24 (3 heads of 8), hidden 48,
   DropPath scales [0, 1/0.9], temperatures between 1 and 100, a bias table
   of 16 * sigmoid values; x and dout rounded to bf16, the parameters fp32.
   Tolerances as the other bf16 forms' (tests/test_torch_bf16_srformerv2.py),
   for arithmetic that rounds to bf16 (2^-8 relative) at the same points in
   both packages, whose fp32 steps sum in other orders and whose XLA CPU
   lowering may keep an fp32 result where the kernel rounds: the output
   within 2^-6 of its largest magnitude, at most one element in a thousand
   beyond 2^-8 of it; dx and each fp32 parameter gradient within 1.5e-2 of
   its tensor's largest magnitude, but for dscale: its nh entries each sum
   dS cos over every window, terms some 150 times the sum in magnitude, so
   bf16 rounding alone moves it some 10% from fp32 (in JAX's kernel as in
   the port's) and where the two round differs by a few percent; it is held
   as the network's gradients are (item 2), against the fp32 plain version
   of the same bf16 inputs in L2: at most twice JAX's distance plus 1e-2 of
   the fp32 norm. Then the bf16 gates: every preset's block at the
   templates' 48x48 crops, and nothing past the engine's rows.
2. A tiny Swin2SR (embed 24, one group of two blocks, 3 heads of 8, window
   8, 2x, a 16x16 LR image: the second block shifted) computing
   in bf16 in training against the flax Swin2SR built with dtype=bfloat16,
   from equal parameters (`state_dict_from_jax`), flax compiled with XLA's
   excess precision off (so it rounds to bf16 after each operation of its
   graph, as on the TPU, where XLA's CPU lowering otherwise keeps fp32
   between fused operations: measured, that alone moves flax's output 2.5%
   of its largest from the port's, against 1.8% with it off), through both
   flax paths:
   its default unfused path (XLA) against the port's unfused branch, and its
   fused path (TRAINNER_FUSED_BLOCK=interpret, the Pallas kernels in
   interpret mode) against the port's kernel branch (the bf16 forms' calls
   counted). The output within 2e-2 of its largest magnitude (as the other
   bf16 families'); each parameter gradient held against the port's fp32
   gradient of the same branch in L2: its distance at most twice the flax
   bf16 gradient's, plus 1e-2 of the fp32 norm of its Swin2Block's
   gradients (elsewhere of its own; L2, as tests/test_torch_bf16_srformerv2.py
   says why; the block's norm as tests/test_torch_bf16_families.py takes the
   block's largest): a bias or LayerNorm gradient sums a random-signed
   cotangent over every token, so bf16 moves it 7-17% from fp32 in either
   package, and the two packages' distances, each a draw of that noise,
   differ by up to 2.2x between the two tiny networks (measured).
Three bf16 `SRModel` steps of it against the JAX `SRModel` are in
tests/test_torch_bf16_swin2sr_steps.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import fused_block_v2 as jv2
from trainner_redux_tpu.ops.pallas.window_attention import shift_mask_kinds
from trainner_redux_tpu_torch.ops import fused_block_v2 as tv2

B, HH, WW, NH, HD, WS, HIDDEN = 2, 16, 16, 3, 8, 8, 48
C, N = NH * HD, WS * WS
S = np.asarray([0.0, 1.0 / 0.9], np.float32)
COS = ("x", "wq", "bq", "scale", "wp", "bp", "g", "be", "bias")
MLP = ("x", "w1", "b1", "w2", "b2", "g", "be")
OUT_TOL = 2.0**-6  # of the largest |output|, about four bf16 steps
OUT_FAR = 2.0**-8  # one bf16 step of the largest |output| ...
OUT_FAR_SHARE = 1e-3  # ... which at most this share of the elements exceed
GRAD_TOL = 1.5e-2  # of each gradient tensor's largest magnitude
GRAD_RATIO, GRAD_SLACK = 2.0, 1e-2  # bf16 L2 error <= RATIO x JAX's (flax's) + SLACK x |fp32 g|


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(seed: int, kinds: int = 1) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bias = 16.0 / (1.0 + np.exp(-normal(NH, N, N)))
    masks = shift_mask_kinds(WS, WS // 2)[:, None] if kinds == 4 else 0.0
    return {
        "x": _bf16(normal(B, HH, WW, C)),
        "wq": normal(C, 3 * C, scale=C**-0.5), "bq": normal(3 * C, scale=0.1),
        "scale": np.exp(rng.uniform(0.0, np.log(100.0), NH)).astype(np.float32),
        "wp": normal(C, C, scale=C**-0.5), "bp": normal(C, scale=0.1),
        "g": 1.0 + normal(C, scale=0.1), "be": normal(C, scale=0.1),
        "bias": np.ascontiguousarray(bias[None] + masks, dtype=np.float32),
        "w1": normal(C, HIDDEN, scale=C**-0.5), "b1": normal(HIDDEN, scale=0.1),
        "w2": normal(HIDDEN, C, scale=HIDDEN**-0.5), "b2": normal(C, scale=0.1),
        "dout": _bf16(normal(B, HH, WW, C)),
    }


def _check(out, want_out, grads, want_grads, fp32_grads=None):
    """The output and gradients of a bf16 form against JAX's, dscale against
    the fp32 plain version's `fp32_grads` (module doc)."""
    assert out.dtype == torch.bfloat16
    want_out = np.asarray(want_out, np.float32)
    err, top = np.abs(out.detach().float().numpy() - want_out), np.abs(want_out).max()
    assert err.max() <= OUT_TOL * top, f"output: max|diff| {err.max():.3g} vs max {top:.3g}"
    assert float((err > OUT_FAR * top).mean()) <= OUT_FAR_SHARE
    for i, ((name, g), w) in enumerate(zip(grads.items(), want_grads)):
        assert g.dtype == (torch.bfloat16 if name == "x" else torch.float32), name
        if name == "scale":
            ref = fp32_grads[i].numpy()
            port, jax_ = (np.linalg.norm(a - ref) for a in (g.numpy(), w))
            assert port <= GRAD_RATIO * jax_ + GRAD_SLACK * np.linalg.norm(ref), (
                f"dscale: off fp32 by {port:.3g} in L2 (JAX bf16 {jax_:.3g})")
            continue
        gerr, gtop = np.abs(g.float().numpy() - w).max(), np.abs(w).max()
        assert gerr <= GRAD_TOL * gtop, f"{name}: max|diff| {gerr:.3g} vs max|g| {gtop:.3g}"


def _leaves(p: dict, names) -> dict[str, torch.Tensor]:
    ts = {k: torch.from_numpy(p[k]).requires_grad_() for k in names if k != "x"}
    return {"x": torch.from_numpy(p["x"]).bfloat16().requires_grad_(), **ts}


@pytest.mark.parametrize("kinds", [1, 4])
def test_bf16_cos_attn_half_matches_jax_vjp(kinds):
    p = _inputs(110 + kinds, kinds)
    shift = WS // 2 if kinds == 4 else 0
    s = jnp.asarray(S)

    def jax_half(x, *rest):
        x = x.astype(jnp.bfloat16)
        if shift:
            x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        z = jv2.fused_cos_attn_block(x, *rest, s, NH, HD, WS, 1e-5, True)
        return jnp.roll(z, (shift, shift), axis=(1, 2)) if shift else z

    want, vjp = jax.vjp(jax_half, *(jnp.asarray(p[k]) for k in COS))
    assert want.dtype == jnp.bfloat16
    want_g = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(p["dout"], jnp.bfloat16))]

    ts = _leaves(p, COS)
    launches = (tv2.fused_cos_attn_block_bf16.launches,
                tv2.fused_cos_attn_block_backward_bf16.launches,
                tv2.fused_cos_attn_block.launches, tv2.fused_cos_attn_block_backward.launches)
    z = tv2.fused_cos_attn_block(*ts.values(), torch.from_numpy(S), NH, HD, WS, 1e-5,
                                 shift=shift)
    z.backward(torch.from_numpy(p["dout"]).bfloat16())
    # CPU tensors: the bf16 plain versions, no kernel launch counted
    assert launches == (tv2.fused_cos_attn_block_bf16.launches,
                        tv2.fused_cos_attn_block_backward_bf16.launches,
                        tv2.fused_cos_attn_block.launches,
                        tv2.fused_cos_attn_block_backward.launches)
    fp32 = tv2.fused_cos_attn_block_bwd_reference(
        *(torch.from_numpy(p[k]) for k in COS), torch.from_numpy(S), torch.from_numpy(p["dout"]),
        NH, HD, WS, 1e-5, shift)
    _check(z, want, {k: t.grad for k, t in ts.items()}, want_g, fp32)


def test_bf16_postnorm_mlp_matches_jax_vjp():
    p = _inputs(120)
    s = jnp.asarray(S)
    want, vjp = jax.vjp(
        lambda x, *rest: jv2.fused_postnorm_mlp(x.astype(jnp.bfloat16), *rest, s, WS, 1e-5, True),
        *(jnp.asarray(p[k]) for k in MLP))
    assert want.dtype == jnp.bfloat16
    want_g = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(p["dout"], jnp.bfloat16))]

    ts = _leaves(p, MLP)
    launches = (tv2.fused_postnorm_mlp_bf16.launches, tv2.fused_postnorm_mlp_backward_bf16.launches)
    out = tv2.fused_postnorm_mlp(*ts.values(), torch.from_numpy(S), WS, 1e-5)
    out.backward(torch.from_numpy(p["dout"]).bfloat16())
    assert launches == (tv2.fused_postnorm_mlp_bf16.launches,
                        tv2.fused_postnorm_mlp_backward_bf16.launches)
    _check(out, want, {k: t.grad for k, t in ts.items()}, want_g)


@pytest.mark.parametrize(("c", "nh"), [(60, 6), (180, 6), (240, 8)])
def test_bf16_gates_take_every_preset(c, nh):
    """Swin2SR-S, -M and -L's blocks at the templates' 48x48 LR crops (and
    at a 64x64 one): both bf16 forms' plans within one thread block's
    232,448 bytes; rows over 256 channels, heads of 40 and 12x12 windows
    are out."""
    for hw in (48, 64):
        assert tv2.cos_attn_bf16_fits(hw, hw, WS, c, nh)
        assert tv2.pn_mlp_bf16_fits(hw, WS, c, 2 * c)
    assert max(tv2.cos_attn_bf16_smem_bytes(c), tv2.pn_mlp_bf16_smem_bytes(c, 2 * c)) <= 232_448
    assert not tv2.cos_attn_bf16_fits(48, 48, WS, 288, 9)
    assert not tv2.pn_mlp_bf16_fits(48, WS, 288, 576)
    assert not tv2.cos_attn_bf16_fits(48, 48, WS, 240, 6)
    assert not tv2.cos_attn_bf16_fits(48, 48, 12, 240, 8)


NET = {"type": "swin2sr_m", "embed_dim": 24, "depths": [2], "num_heads": [3], "num_feat": 16,
       "drop_path_rate": 0.0, "scale": 2}
NET_OUT_TOL = 2e-2  # of the largest |output|
BF16_FORMS = ("fused_cos_attn_block_bf16", "fused_cos_attn_block_backward_bf16",
              "fused_postnorm_mlp_bf16", "fused_postnorm_mlp_backward_bf16")


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


@pytest.mark.parametrize("path", ["unfused", "kernels"])
def test_bf16_swin2sr_matches_flax(path, monkeypatch):
    from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
    from trainner_redux_tpu.models.base_model import BaseModel
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    # flax's default path (the SwinV2 kernels off outside interpret mode)
    # builds the same parameters as its fused path, without the kernels
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    rng = np.random.default_rng(4)
    lr = rng.random((1, 16, 16, 3)).astype(np.float32)
    wout = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    init = jax.jit(functools.partial(jax_build_cast(dict(NET), jnp.float32).init, train=False))(
        jax.random.key(0), jnp.asarray(lr))["params"]
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(init).items()}
    if path == "kernels":
        monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    jnet = jax_build_cast(dict(NET), jnp.bfloat16)

    def jloss(params):
        out = jnet.apply({"params": params}, jnp.asarray(lr), train=True)
        return jnp.sum(out * wout), out

    params = BaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    # flax rounds to bf16 where its graph says (as on the TPU): XLA's CPU
    # excess precision, which keeps fp32 between fused ops, off
    step = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (_, want), jgrads = step(params)
    want_g = {k: np.asarray(v) for k, v in
              state_dict_from_jax(BaseModel.flatten_params(jgrads), "Swin2SR").items()}

    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "1" if path == "kernels" else "0")
    calls = _counting(monkeypatch, tv2, BF16_FORMS)
    nets = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = build_network_cast(dict(NET), dtype)
        assert net.compute_dtype == dtype and net.bf16_refusal() is None
        net.load_state_dict(state_dict_from_jax(flat, "Swin2SR"))
        net.train()
        out = net(torch.from_numpy(lr).permute(0, 3, 1, 2))
        assert out.dtype == torch.float32
        (out * torch.from_numpy(wout).permute(0, 3, 1, 2)).sum().backward()
        nets[dtype] = (out.detach().permute(0, 2, 3, 1).numpy(),
                       {k: p.grad.numpy() for k, p in net.named_parameters()
                        if p.grad is not None})
    # the kernel branch: both blocks on the bf16 forms, once each way
    assert calls == dict.fromkeys(BF16_FORMS, 2 if path == "kernels" else 0)
    got, got_g = nets[torch.bfloat16]
    want = np.asarray(want)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= NET_OUT_TOL * top, f"output: max|diff| {err:.3g} vs max {top:.3g}"
    fp32_g = nets[torch.float32][1]
    assert got_g.keys() == fp32_g.keys() == want_g.keys()

    def group(k):  # a Swin2Block's parameters, else the tensor alone
        parts = k.split(".")
        return ".".join(parts[:5]) if "blocks" in parts else k

    norms: dict[str, float] = {}
    for k, g in fp32_g.items():
        norms[group(k)] = float(np.hypot(norms.get(group(k), 0.0), np.linalg.norm(g)))
    for k, g in got_g.items():
        assert g.dtype == np.float32, k
        port, flax = (np.linalg.norm(a - fp32_g[k]) for a in (g, want_g[k]))
        top = norms[group(k)]
        assert port <= GRAD_RATIO * flax + GRAD_SLACK * top, (
            f"{k}: bf16 off fp32 by {port:.3g} in L2 (flax bf16 {flax:.3g}) of |g| {top:.3g}")


S2_TRAIN_TEMPLATES = [f"swin2sr_{p}_{kind}" for p in ("s", "m", "l")
                      for kind in ("fidelity", "gan", "otf")]


@pytest.mark.parametrize("template", S2_TRAIN_TEMPLATES)
def test_swin2sr_training_templates_build_in_bf16(template):
    """Each of the nine Swin2SR training templates ships `compute_dtype:
    bfloat16`, and its network builds computing in bf16 with no refusal
    (the model's `_bf16_refusal` asks the network's)."""
    from pathlib import Path

    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.options import yaml_load

    path = (Path(__file__).resolve().parent.parent / "configs" / "_templates" / "train"
            / "Swin2SR" / f"{template}.yml")
    opt, _ = yaml_load(str(path))
    assert opt.compute_dtype == "bfloat16"
    net = build_network_cast({**opt.network_g, "scale": opt.scale}, torch.bfloat16)
    assert net.compute_dtype == torch.bfloat16 and net.bf16_refusal() is None
