"""Torch port's ATD vs the JAX package's, on the CPU (the port's kernel
wrappers run their plain versions).

- the presets `atd` (embed 210, 6 heads of 35, ws 16) and `atd_light`
  (embed 48, 6 heads of 8) have the JAX presets' parameter shapes through
  the weight bridge;
- the bridge: the port's seeded init through the JAX `_convert_atd` and
  back through `state_dict_from_jax(flat, "ATD")` bit for bit; the JAX
  `_export_atd` refuses it, since the JAX tree (as the port) trains
  `attn_win.qkv` and `attn_aca.qkv` apart where upstream shares `wqkv`;
- an upstream-layout checkpoint (one `wqkv`, the `residual_group.layers`
  container, `token_dict`, the ConvFFN's `depthwise_conv.0`, a flat
  `sigma`, index buffers) through `SRModel.load_network`, equal to the JAX
  `_convert_atd` of the same dict; a `norm3` refused by both;
- tiny networks in fp32 against the JAX ATD: train and eval forwards within
  1e-4 of the output's largest, L1 gradients within 1e-4 of each tensor's
  largest: one with a head of 40 channels (embed 40, one group of two
  layers, ws 8: the second layer shifted; the window attention through the
  64-wide form's plain version) on 16x16 and 12x20 (reflect-padded to
  16x24), and a light-shaped one (3 heads of 8, ws 16, pixelshuffledirect);
  category_size 48 on 256 or 384 tokens: groups of 48 and a padded last one;
- the discrete steps: each layer's categories equal between the packages
  (the smallest top-two margin of `sim` printed); `AdaptiveCategoryMSA`
  of both packages on one shared `sim` (a padded last group), output and
  gradients; `category_order` against jnp's argmax / stable argsort on
  ties; the permutation gather's gradient equal to the scatter form's, two
  backward passes bit for bit;
- the head-40 net in bf16 against flax's bf16 (tests/test_torch_span.py's
  `check_bf16`);
- three `SRModel` steps and the 12 templates: tests/test_torch_atd_steps.py.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_span import (
    check_bf16,
    check_fp32,
    check_preset,
    lr_batch,
    nchw,
    shared_params,
)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

TINY = {"type": "atd", "embed_dim": 40, "depths": [2], "num_heads": [1], "window_size": 8,
        "category_size": 48, "num_tokens": 16, "reducted_dim": 8, "convffn_kernel_size": 5,
        "mlp_ratio": 2, "num_feat": 16}
LIGHT = {"type": "atd_light", "embed_dim": 24, "depths": [2], "num_heads": [3],
         "window_size": 16, "category_size": 48, "num_tokens": 16, "reducted_dim": 8}


@pytest.mark.parametrize("preset", ["atd", "atd_light"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


def test_bridge_round_trips_and_the_jax_export_refuses_untied_qkv():
    """The JAX package's own fault (ROADMAP.md section 3): its ATD trains
    two qkv weights, so `_export_atd` cannot write upstream's one `wqkv`."""
    from trainner_redux_tpu.utils.torch_compat import _export_atd

    flat, net = shared_params(TINY, 2, "ATD")  # bit for bit both ways
    sd = net.state_dict()
    for k in ("layers.0.td", "layers.0.conv.weight", "layers.0.layers.1.attn_win.qkv.weight",
              "layers.0.layers.1.attn_aca.qkv.weight", "layers.0.layers.0.convffn.dwconv.weight",
              "layers.0.layers.0.attn_atd.scale", "layers.0.layers.0.sigma"):
        assert k in sd, k
    with pytest.raises(ValueError, match="attn_win.qkv != attn_aca.qkv"):
        _export_atd(flat)


def _upstream(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The port's state dict in upstream ATD's layout: one `wqkv` (the
    window attention's), the `residual_group.layers` container, the
    dictionary as `token_dict`, `depthwise_conv.0`, a flat sigma, the
    recomputed buffers upstream saves."""
    out = {}
    for k, v in sd.items():
        if ".attn_aca.qkv." in k:
            continue
        k = k.replace(".attn_win.qkv.", ".wqkv.").replace(".dwconv.", ".dwconv.depthwise_conv.0.")
        k = k.replace(".layers.", ".residual_group.layers.", 1) if k.count(".layers.") else k
        if k.endswith(".td"):
            k = k[: -len("td")] + "residual_group.token_dict"
        out[k] = v.reshape(-1) if k.endswith(".sigma") else v
    out["layers.0.residual_group.layers.0.attn_win.relative_position_index"] = np.zeros(
        (64, 64), np.int64)
    return out


def _load_network(path: Path, tmp_path: Path):
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = {"name": "atd_upstream", "scale": 2, "num_gpu": 1, "network_g": dict(TINY),
           "path": {"pretrain_network_g": str(path), "strict_load_g": True}}
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    return build_model(opt, device="cpu").net_g


def test_upstream_checkpoint_through_load_network(tmp_path):
    from trainner_redux_tpu.utils.torch_compat import _convert_atd

    src = jax_build_network({**TINY, "scale": 2})
    _, net = shared_params(TINY, 2, "ATD")
    up = _upstream({k: v.numpy() for k, v in net.state_dict().items()})
    path = tmp_path / "atd_upstream.pth"
    torch.save({"params": {k: torch.from_numpy(v) for k, v in up.items()}}, path)
    got = _load_network(path, tmp_path).state_dict()
    want = state_dict_from_jax(_convert_atd(up, src), "ATD")
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    qkv = "layers.0.layers.1.{}.qkv.weight"
    assert torch.equal(got[qkv.format("attn_win")], got[qkv.format("attn_aca")])

    up["layers.0.residual_group.layers.0.norm3.weight"] = np.ones(40, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in up.items()}, path)
    with pytest.raises(NotImplementedError, match="norm3"):
        _load_network(path, tmp_path)
    with pytest.raises(NotImplementedError, match="norm3"):
        _convert_atd(up, src)


@pytest.mark.parametrize(("net", "h", "w"), [(TINY, 16, 16), (TINY, 12, 20), (LIGHT, 16, 16)],
                         ids=["hd40", "hd40-padded", "light"])
def test_atd_matches_jax(net, h, w):
    check_fp32(net, "ATD", 2, h, w)


def _jax_sims(net_opt: dict, flat: dict, lr: np.ndarray) -> list[np.ndarray]:
    """Each layer's sim from the JAX ATD's eval forward, in layer order."""
    from trainner_redux_tpu.archs.atd_arch import ATDCrossAttention

    jnet = jax_build_network({**net_opt, "scale": 2})
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    _, state = jax.jit(lambda p, x: jnet.apply(
        {"params": p}, x, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, ATDCrossAttention)))(
        params, jnp.asarray(lr))
    groups = state["intermediates"]
    return [np.asarray(groups[g][layer]["attn_atd"]["__call__"][0][1])
            for g in sorted(groups, key=lambda s: int(s.split("_")[1]))
            for layer in sorted(groups[g], key=lambda s: int(s.split("_")[1]))]


@pytest.mark.parametrize("net_opt", [TINY, LIGHT], ids=["hd40", "light"])
def test_categories_match_jax_per_layer(net_opt):
    """The discrete step: argmax of each layer's sim, port against JAX; the
    smallest top-two margin of the port's sim says how near a flip was."""
    from trainner_redux_tpu_torch.archs.atd_arch import ATDCrossAttention

    flat, net = shared_params(net_opt, 2, "ATD")
    lr = lr_batch(6)
    sims = []
    for m in net.modules():
        if isinstance(m, ATDCrossAttention):
            m.register_forward_hook(lambda _m, _i, out: sims.append(out[1].detach().numpy()))
    with torch.no_grad():
        net.eval()(nchw(lr))
    want = _jax_sims(net_opt, flat, lr)
    assert len(sims) == len(want) == 2
    for i, (got, ref) in enumerate(zip(sims, want)):
        top2 = np.sort(got, axis=-1)[..., -2:]
        margin = float((top2[..., 1] - top2[..., 0]).min())
        flips = int((got.argmax(-1) != ref.argmax(-1)).sum())
        print(f"layer {i}: smallest top-two margin of sim {margin:.3g}, {flips} categories differ")
        assert flips == 0, f"layer {i}: {flips} categories differ (smallest margin {margin:.3g})"
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_adaptive_category_msa_on_a_shared_sim():
    """Both packages' AdaptiveCategoryMSA on one sim (so one sort): 100
    tokens in groups of 32, the last padded by 28; output within 1e-5 and
    the gradients of x and the parameters within 1e-4 of each largest."""
    from trainner_redux_tpu.archs.atd_arch import AdaptiveCategoryMSA as JaxACA
    from trainner_redux_tpu_torch.archs.atd_arch import AdaptiveCategoryMSA

    rng = np.random.default_rng(11)
    b, n, c, nh, cs, m = 2, 100, 24, 3, 32, 16
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    logits = rng.standard_normal((b, n, m)).astype(np.float32) * 3
    sim = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cot = rng.standard_normal((b, n, c)).astype(np.float32)
    jmod = JaxACA(c, nh, cs)
    params = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(sim))["params"]
    out, (jgp, jgx) = jax.jit(lambda p, xx, ct: (lambda o, f: (o, f(ct)))(*jax.vjp(
        lambda pp, x2: jmod.apply({"params": pp}, x2, jnp.asarray(sim)), p, xx)))(
        params, jnp.asarray(x), jnp.asarray(cot))

    mod = AdaptiveCategoryMSA(c, nh, cs)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(mod, name).weight.copy_(torch.from_numpy(np.asarray(params[name]["kernel"]).T))
            getattr(mod, name).bias.copy_(torch.from_numpy(np.asarray(params[name]["bias"])))
    tx = torch.from_numpy(x).requires_grad_()
    got = mod(tx, torch.from_numpy(sim))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    pairs = [(tx.grad, jgx)] + [(getattr(mod, nm).weight.grad.T, jgp[nm]["kernel"])
                                for nm in ("qkv", "proj")]
    for g, w in pairs:
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_category_order_matches_jnp_on_ties():
    """argmax takes the first of equal maxima and the sort is stable, as
    jnp's; the inverse order inverts it."""
    from trainner_redux_tpu_torch.archs.atd_arch import category_order

    rng = np.random.default_rng(3)
    sim = rng.integers(0, 3, (2, 64, 5)).astype(np.float32)  # ties within rows and categories
    cat, order, inv = category_order(torch.from_numpy(sim))
    jcat = jnp.argmax(jnp.asarray(sim), axis=-1)
    jorder = jnp.argsort(jcat, axis=-1)
    np.testing.assert_array_equal(cat.numpy(), np.asarray(jcat))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jnp.argsort(jorder, axis=-1)))


def test_permutation_gather_gradient():
    """The gather by `order` has the gather by its inverse as its backward:
    equal to autograd's scatter form, and bit-identical run to run."""
    from trainner_redux_tpu_torch.archs.atd_arch import category_order, permute_tokens

    gen = torch.Generator().manual_seed(5)
    _, order, inv = category_order(torch.rand(3, 77, 6, generator=gen))
    x = torch.randn(3, 77, 10, generator=gen)
    w = torch.randn(3, 77, 10, generator=gen)
    grads = []
    for _ in range(2):
        tx = x.clone().requires_grad_()
        y = permute_tokens(tx, order, inv)
        (y * w).sum().backward()
        grads.append(tx.grad)
    sx = x.clone().requires_grad_()
    ys = sx.gather(1, order[..., None].expand(-1, -1, 10))
    (ys * w).sum().backward()
    assert torch.equal(y.detach(), ys.detach())
    assert torch.equal(grads[0], sx.grad)
    assert torch.equal(grads[0], grads[1])


def test_atd_bf16_matches_flax():
    check_bf16(TINY, "ATD", 2)
