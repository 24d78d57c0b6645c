"""The port's SPAN and SPANF against the JAX package's, on the CPU (no
kernel: the conv families run cuDNN on the card and PyTorch's convolutions
here); the helpers serve tests/test_torch_spanplus.py (SPANPlus) and
tests/test_torch_spanc.py (SpanC) too.

- every preset (span, span_s, span_f32/64/96, spanf) has, through the
  weight bridge `state_dict_from_jax`, the JAX preset's parameters: the
  port's keys and shapes (JAX shapes from eval_shape);
- tiny networks (16 channels; SPAN with and without norm), the weights of
  the port's seeded init (upstream's scheme) taken into the JAX package by
  its own converter and back through the bridge bit for bit, 2x and 4x on a
  batch of two LR images (16x16 and 12x20): the fp32 output within 1e-4 of
  its largest magnitude, in train mode (Conv3XC's 1x1-3x3-1x1 chain on the
  padded input) and in eval mode (its folded 3x3), and the gradients of an
  L1 loss in train mode within 1e-4 of each tensor's largest;
- in bf16 (`build_network_cast`) against flax with dtype=bfloat16 (XLA's
  excess precision off, so flax rounds where its graph does), train mode:
  the output within 2e-2 of its largest, each parameter gradient's
  L2 distance from the port's fp32 gradient at most twice flax's plus 1e-2
  of the fp32 gradient's norm (tests/test_torch_bf16_gan.py's
  `hold_to_fp32`);
- the golden fixtures `span`, `span_norm` and `spanf` (reference-torch
  networks and their outputs, the configs of
  tests/test_utils/test_golden_parity.py) loaded strictly through
  `SRModel.load_network`, the folded `eval_conv` copies dropped (SPANF's
  weights are its `eval_conv`s and stay): the output within 2e-4 of its
  largest, and a JAX-framework checkpoint of the same network through the
  same call.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_gan import hold_to_fp32
from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.archs import build_network, build_network_cast
from trainner_redux_tpu_torch.utils.torch_compat import _KEY_MAPS, state_dict_from_jax

GOLDEN = Path(__file__).resolve().parent / "golden"
FWD_TOL = 1e-4  # of the largest |output|
GRAD_TOL = 1e-4  # of each gradient tensor's largest
BF16_OUT_TOL = 2e-2  # of the largest |output|
GOLDEN_TOL = 2e-4  # of the largest |output|

NETS = {
    "span": ({"type": "span", "feature_channels": 16}, "SPAN"),
    "span_norm": ({"type": "span", "feature_channels": 16, "norm": True}, "SPAN"),
    "spanf": ({"type": "spanf", "feature_channels": 16}, "SPANF"),
    "spanplus_dys": ({"type": "spanplus", "feature_channels": 16, "blocks": [1]}, "SpanPlus"),
    "spanplus_ps": ({"type": "spanplus", "feature_channels": 16, "blocks": [1],
                     "upsampler": "ps"}, "SpanPlus"),
    "spanc": ({"type": "spanc", "feature_channels": 16, "implicit_dim": 16,
               "latent_layers": 2}, "SpanC"),
}
PRESETS = {"span": "SPAN", "span_s": "SPAN", "span_f32": "SPAN", "span_f64": "SPAN",
           "span_f96": "SPAN", "spanf": "SPANF", "spanplus": "SpanPlus",
           "spanplus_s": "SpanPlus", "spanplus_st": "SpanPlus", "spanplus_sts": "SpanPlus",
           "spanc": "SpanC", "spanpp": "SpanC", "compact": "SRVGGNetCompact",
           "ultracompact": "SRVGGNetCompact", "superultracompact": "SRVGGNetCompact",
           "srvggnetcompact": "SRVGGNetCompact", "esrgan": "RRDBNet", "esrgan_lite": "RRDBNet",
           "srformer": "SRFormer", "srformer_light": "SRFormer", "atd": "ATD",
           "atd_light": "ATD"}
# the golden fixtures' configs (tests/test_utils/test_golden_parity.py, FLAX_OPTS)
GOLDEN_NETS = {
    "span": {"type": "span", "scale": 2, "feature_channels": 16},
    "span_norm": {"type": "span", "scale": 2, "feature_channels": 16, "norm": True},
    "spanf": {"type": "spanf", "scale": 2, "feature_channels": 16},
    "spanplus": {"type": "spanplus", "scale": 2, "feature_channels": 16, "blocks": [1],
                 "upsampler": "ps"},
    "spanpp": {"type": "spanpp", "scale": 2, "feature_channels": 16, "implicit_dim": 8,
               "latent_layers": 1, "max_scale": 2},
}


def lr_batch(seed: int, h: int = 16, w: int = 16) -> np.ndarray:
    """Two NHWC LR images in [0, 1]."""
    return np.random.default_rng(seed).random((2, h, w, 3)).astype(np.float32)


def shared_params(net_opt: dict, scale: int, arch: str) -> tuple[dict, torch.nn.Module]:
    """(the JAX package's flattened parameters, the port's network) holding
    the same weights: the port's seeded init (upstream's scheme, under
    which these networks are well conditioned in fp32 and bf16) converted
    by the JAX package's own converter of upstream checkpoints, then read
    back into a fresh port network through `state_dict_from_jax`, which
    must give every parameter back bit for bit."""
    from trainner_redux_tpu.utils.torch_compat import _CONVERTERS

    src = build_network({**net_opt, "scale": scale}).init_weights(
        torch.Generator().manual_seed(0))
    jnet = jax_build_network({**net_opt, "scale": scale})
    flat = _CONVERTERS[arch.lower()]({k: v.numpy() for k, v in src.state_dict().items()}, jnet)
    net = port_net(net_opt, scale, flat, arch)
    for k, v in src.named_parameters():
        torch.testing.assert_close(dict(net.named_parameters())[k], v, rtol=0, atol=0)
    return flat, net


def port_net(net_opt: dict, scale: int, flat: dict, arch: str,
             dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The port's network with the JAX parameters through the bridge; only
    buffers (SPAN's no_norm, SpanC's MetaIGConv, DySample's init_pos) are
    left to the network."""
    net = build_network_cast({**net_opt, "scale": scale}, dtype)
    sd = state_dict_from_jax(flat, arch, keys=net.state_dict().keys())
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {k for k, _ in net.named_buffers()}, (
        missing, unexpected)
    return net


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_port_grads(tree, arch: str, keys) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in
            state_dict_from_jax(JaxBaseModel.flatten_params(tree), arch, keys=keys).items()}


def param_grads(net: torch.nn.Module) -> dict[str, np.ndarray]:
    """Each parameter's gradient, zeros where autograd left none (a
    parameter the loss does not reach, as ATD's last dictionary refresh):
    jax.grad's zero, which the port's SRModel also steps with."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for k, p in net.named_parameters()}


def check_fp32(net_opt: dict, arch: str, scale: int, h: int, w: int) -> None:
    """Train and eval forwards and the train-mode L1 gradients, fp32."""
    flat, net = shared_params(net_opt, scale, arch)
    jnet = jax_build_network({**net_opt, "scale": scale})
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    lr = lr_batch(2, h, w)
    gt = np.random.default_rng(3).random((2, h * scale, w * scale, 3)).astype(np.float32)

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(lr), train=True)
        return jnp.mean(jnp.abs(out - gt)), out

    (_, want_train), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want_eval = jax.jit(functools.partial(jnet.apply, train=False))(
        {"params": params}, jnp.asarray(lr))
    for train, want in ((True, want_train), (False, want_eval)):
        want = np.asarray(want)
        net.train(train)
        out = net(nchw(lr))
        if train:
            torch.mean(torch.abs(out - nchw(gt))).backward()
        got = out.detach().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, h * scale, w * scale, 3)
        err, top = np.abs(got - want).max(), np.abs(want).max()
        assert err <= FWD_TOL * top, f"train={train}: max|diff| {err:.3g} vs max {top:.3g}"

    want_g = to_port_grads(jgrads, arch, net.state_dict().keys())
    got_g = param_grads(net)
    assert got_g.keys() == want_g.keys()
    for k, g in got_g.items():
        err, top = np.abs(g - want_g[k]).max(), np.abs(want_g[k]).max()
        assert err <= GRAD_TOL * top, f"{k}: grad max|diff| {err:.3g} vs max {top:.3g}"


def check_bf16(net_opt: dict, arch: str, scale: int, h: int = 16, w: int = 16) -> None:
    """bf16 train-mode forward against flax's bf16 one, gradients held
    against the port's fp32 ones as flax's are."""
    flat, _ = shared_params(net_opt, scale, arch)
    jnet = jax_build_cast({**net_opt, "scale": scale}, jnp.bfloat16)
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    rng = np.random.default_rng(4)
    lr = lr_batch(5, h, w)
    wout = rng.standard_normal((2, h * scale, w * scale, 3)).astype(np.float32)

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(lr), train=True)
        return jnp.sum(out * wout), out

    # flax rounds to bf16 where its graph says (as on the TPU): XLA's CPU
    # excess precision, which keeps fp32 between fused ops, off
    step = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (_, want), jgrads = step(params)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = port_net(net_opt, scale, flat, arch, dtype).train()
        assert net.compute_dtype == dtype and net.bf16_refusal() is None
        out = net(nchw(lr))
        assert out.dtype == torch.float32
        (out * nchw(wout)).sum().backward()
        results[dtype] = (out.detach().permute(0, 2, 3, 1).numpy(), param_grads(net), net)
    got, got_g, net = results[torch.bfloat16]
    want = np.asarray(want)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BF16_OUT_TOL * top, f"bf16 output: max|diff| {err:.3g} vs max {top:.3g}"
    flax_g = to_port_grads(jgrads, arch, net.state_dict().keys())
    hold_to_fp32(arch, got_g, flax_g, results[torch.float32][1])


def check_preset(preset: str) -> None:
    """The preset's parameters through the bridge: the port's keys and
    shapes, from the JAX preset's (eval_shape: nothing is initialised)."""
    arch = PRESETS[preset]
    jnet = jax_build_network({"type": preset, "scale": 4})
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                                              train=True))["params"]
    port = build_network({"type": preset, "scale": 4})
    buffers = {k for k, _ in port.named_buffers()}
    keys = port.state_dict().keys()
    flat = {".".join(p.key for p in path): np.zeros(s.shape, np.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(flat, arch, keys=keys).items()}
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items() if k not in buffers}
    assert arch.lower() in _KEY_MAPS


@pytest.mark.parametrize("preset", ["span", "span_s", "span_f32", "span_f64", "span_f96",
                                    "spanf"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


@pytest.mark.parametrize("name,scale,h,w", [
    ("span", 2, 16, 16), ("span_norm", 4, 12, 20), ("spanf", 4, 12, 20)])
def test_span_family_matches_jax(name, scale, h, w):
    net_opt, arch = NETS[name]
    check_fp32(net_opt, arch, scale, h, w)


@pytest.mark.parametrize("name", ["span", "spanf"])
def test_span_family_bf16_matches_flax(name):
    net_opt, arch = NETS[name]
    check_bf16(net_opt, arch, 2)


def load_through_model(tmp_path, net_opt: dict, weights: Path):
    """The network of `net_opt` built by the port's SRModel (serving) with
    `weights` loaded strictly through `load_network`."""
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    net_opt = dict(net_opt)
    raw = {"name": "golden", "scale": net_opt.pop("scale"), "num_gpu": 1,
           "network_g": net_opt,
           "path": {"pretrain_network_g": str(weights), "strict_load_g": True}}
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    return build_model(opt, device="cpu").net_g


def check_golden(tmp_path, case: str, net_opt: dict, arch: str) -> None:
    """The reference checkpoint, and the JAX package's parameters of the same
    network saved as a JAX-framework file, through `load_network`."""
    from safetensors.numpy import save_file

    from trainner_redux_tpu.utils.torch_compat import load_torch_checkpoint

    data = np.load(GOLDEN / f"{case}.npz")
    x, y = data["x"], data["y"]
    net = load_through_model(tmp_path, net_opt, GOLDEN / f"{case}.safetensors")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == y.shape
    err, top = np.abs(got - y).max(), np.abs(y).max()
    assert err <= GOLDEN_TOL * top, f"{case}: max|diff| {err:.3g} vs max {top:.3g}"

    jnet = jax_build_network(dict(net_opt))
    template = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.asarray(
        x.transpose(0, 2, 3, 1)), train=False))["params"]
    params = load_torch_checkpoint(str(GOLDEN / f"{case}.safetensors"), jnet, template)
    jax_file = tmp_path / f"{case}_jax.safetensors"
    save_file({k: np.asarray(v) for k, v in JaxBaseModel.flatten_params(params).items()},
              str(jax_file), metadata={"framework": "trainner_redux_tpu", "arch": arch})
    net = load_through_model(tmp_path, net_opt, jax_file)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    err = np.abs(got - y).max()
    assert err <= GOLDEN_TOL * top, f"{case} via JAX: max|diff| {err:.3g} vs max {top:.3g}"


GOLDEN_ARCH = {"span": "SPAN", "span_norm": "SPAN", "spanf": "SPANF", "spanplus": "SpanPlus",
               "spanpp": "SpanC"}


@pytest.mark.parametrize("case", ["span", "span_norm", "spanf"])
def test_golden_fixture_through_load_network(case, tmp_path):
    check_golden(tmp_path, case, GOLDEN_NETS[case], GOLDEN_ARCH[case])


def test_folded_copies_dropped_only_where_recomputed():
    """An upstream SPAN checkpoint's `eval_conv` keys are dropped; SPANF's
    are its weights and stay."""
    from trainner_redux_tpu_torch.utils.torch_compat import drop_folded_copies, \
        load_torch_state_dict

    span = load_torch_state_dict(str(GOLDEN / "span.safetensors"))
    kept = drop_folded_copies(span, build_network(dict(GOLDEN_NETS["span"])).state_dict().keys())
    assert any(".eval_conv." in k for k in span) and not any(".eval_conv." in k for k in kept)
    spanf = load_torch_state_dict(str(GOLDEN / "spanf.safetensors"))
    keys = build_network(dict(GOLDEN_NETS["spanf"])).state_dict().keys()
    assert drop_folded_copies(spanf, keys).keys() == spanf.keys() == set(keys)
