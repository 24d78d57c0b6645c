"""The port's DUnet discriminator and its pieces vs the JAX package's, on the
CPU, from numpy-seeded inputs.

- `SNConv2d` in train mode (one power iteration from the stored u, nothing
  written), in eval mode (sigma from the stored pair) and the refresh (the
  JAX mutable forward's new u and v): outputs within 1e-4, gradients of the
  input and the weight within 1e-4 of their largest (`jax.vjp`);
- `dysample_local` at radius 1 and 2 with offsets up to 3 pixels, so that
  the clamp to the window and to the image acts, and DySample's gather
  mode (TRAINNER_DYSAMPLE_MODE=gather) with offsets of several pixels:
  outputs and gradients the same way;
- DUnet (num_feat 16, 32x32, return_features) in train and eval mode: the
  logits and the four features, and the gradients of x and of every
  parameter;
- the weight bridge: the port's state dict through the JAX `_convert_dunet`
  and back through `state_dict_from_jax`, bit for bit; a JAX-framework
  net_d file, which holds no (u, v), through `SRModel.load_network`;
- the golden `dunet` fixture (upstream's DUnet and its output) through
  `SRModel.load_network` in eval mode, within 2e-4 * max(1, |y|), the JAX
  golden test's tolerance; upstream's legacy spectral-norm keys load too.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.archs import arch_util as port_util
from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

GOLDEN = Path(__file__).resolve().parent / "golden"
TOL = 1e-4
NF = 16


def _close(got, want, what: str, tol: float = TOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), f"{what}: {err:.3g}"


def _grad_close(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), f"{what}: {err:.3g} of {np.abs(want).max():.3g}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SNConv2d
# ---------------------------------------------------------------------------


def _sn_pair(stride: int):
    """A JAX SNConv2d and the port's with the same weight, bias and a random
    (u, v) pair (not the one init draws), and an input."""
    from trainner_redux_tpu.archs.arch_util import SNConv2d as JaxSNConv2d

    rng = np.random.default_rng(3)
    cin, cout = 6, 10
    x = rng.standard_normal((2, 12, 12, cin)).astype(np.float32)
    jnet = JaxSNConv2d(cout, 3, stride=stride, padding=1)
    variables = jnet.init(jax.random.key(0), jnp.asarray(x), True)
    kernel = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.3
    bias = rng.standard_normal(cout).astype(np.float32) * 0.1
    u = rng.standard_normal(cout).astype(np.float32)
    v = rng.standard_normal(9 * cin).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    spectral = {"u": jnp.asarray(u), "v": jnp.asarray(v)}
    assert jax.tree.structure(variables["params"]) == jax.tree.structure(params)

    conv = port_util.SNConv2d(cin, cout, 3, stride, 1)
    sd = state_dict_from_jax({"e_x1.conv.kernel": kernel, "e_x1.conv.bias": bias,
                              "__spectral__.e_x1.conv.u": u, "__spectral__.e_x1.conv.v": v},
                             "DUnet")
    conv.load_state_dict({k.removeprefix("e_x1.0."): t for k, t in sd.items()
                          if k.startswith("e_x1.0.")})
    return jnet, params, spectral, conv, x


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("train", [True, False])
def test_snconv2d_forward_and_gradients_match_jax(stride, train):
    jnet, params, spectral, conv, x = _sn_pair(stride)
    conv.train(train)

    def f(p, xx):
        return jnet.apply({"params": p, "spectral": spectral}, xx, train)

    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    g = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_(True)
    got = conv(xt)
    _close(_nhwc(got), want, "output")
    got.backward(_nchw(g))
    _grad_close(_nhwc(xt.grad), dx, "dx")
    dw = conv.parametrizations.weight.original.grad.numpy().transpose(2, 3, 1, 0)
    _grad_close(dw, dparams["kernel"], "dkernel")
    _grad_close(conv.bias.grad.numpy(), dparams["bias"], "dbias")
    # the forward writes nothing
    sn = conv.parametrizations.weight[0]
    _close(sn._u.numpy(), spectral["u"], "u unchanged", 0)


def test_snconv2d_refresh_matches_the_jax_mutable_forward():
    jnet, params, spectral, conv, x = _sn_pair(1)
    _, upd = jnet.apply({"params": params, "spectral": spectral}, jnp.asarray(x), True,
                        mutable=["spectral"])
    conv.train()
    port_util.refresh_spectral_norms(conv)
    sn = conv.parametrizations.weight[0]
    _close(sn._u.numpy(), upd["spectral"]["u"], "u")
    v = np.asarray(upd["spectral"]["v"]).reshape(3, 3, 6).transpose(2, 0, 1).reshape(-1)
    _close(sn._v.numpy(), v, "v")


# ---------------------------------------------------------------------------
# DySample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [1, 2])
def test_dysample_local_matches_jax(radius):
    """Offsets up to 3 px: beyond each radius, and past the image's edge
    at the borders, so both clamps act."""
    from trainner_redux_tpu.archs.arch_util import dysample_local as jax_dysample_local

    rng = np.random.default_rng(radius)
    n, h, w, c, g, s = 2, 6, 7, 8, 4, 2
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.uniform(-3, 3, (n, h, w, 2, g, s, s))).astype(np.float32)

    want, vjp = jax.vjp(lambda a, b: jax_dysample_local(a, b, s, g, radius),
                        jnp.asarray(x), jnp.asarray(off))
    gy = rng.standard_normal(want.shape).astype(np.float32)
    dx, doff = vjp(jnp.asarray(gy))

    xt = _nchw(x).requires_grad_(True)
    # (n, h, w, coord, g, sy, sx) -> (n, coord, g, sy, sx, h, w)
    ot = torch.from_numpy(off.transpose(0, 3, 4, 5, 6, 1, 2).copy()).requires_grad_(True)
    got = port_util.dysample_local(xt, ot, s, g, radius)
    _close(_nhwc(got), want, "output")
    got.backward(_nchw(gy))
    _grad_close(_nhwc(xt.grad), dx, "dx")
    _grad_close(ot.grad.numpy().transpose(0, 5, 6, 1, 2, 3, 4), doff, "doffset")


@pytest.mark.parametrize("mode", ["gather", "local"])
def test_dysample_module_matches_jax(mode, monkeypatch):
    """The whole upsampler (offset and scope convolutions, the sigmoid gate,
    the anchors) with offset weights scaled up to offsets of several
    pixels; 'gather' samples without a window."""
    from trainner_redux_tpu.archs.arch_util import DySample as JaxDySample

    monkeypatch.setenv("TRAINNER_DYSAMPLE_MODE", mode)
    monkeypatch.delenv("TRAINNER_DYSAMPLE_RADIUS", raising=False)
    rng = np.random.default_rng(7)
    c = 8
    x = rng.standard_normal((2, 6, 6, c)).astype(np.float32)
    jnet = JaxDySample(c, c, scale=2, groups=4, end_convolution=False, local_radius=1)
    params = jnet.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 2.0), params)

    want, vjp = jax.vjp(lambda p, a: jnet.apply({"params": p}, a), params, jnp.asarray(x))
    gy = rng.standard_normal(want.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(gy))

    net = port_util.DySample(c, scale=2, groups=4, local_radius=1)
    flat = JaxBaseModel.flatten_params(params)
    net.load_state_dict({
        "offset.weight": torch.from_numpy(flat["offset.conv.kernel"].transpose(3, 2, 0, 1).copy()),
        "offset.bias": torch.from_numpy(flat["offset.conv.bias"]),
        "scope.weight": torch.from_numpy(flat["scope.conv.kernel"].transpose(3, 2, 0, 1).copy()),
        "init_pos": port_util.dysample_init_pos(2, 4),
    })
    xt = _nchw(x).requires_grad_(True)
    got = net(xt)
    _close(_nhwc(got), want, f"{mode} output")
    got.backward(_nchw(gy))
    _grad_close(_nhwc(xt.grad), dx, f"{mode} dx")
    dflat = JaxBaseModel.flatten_params(dparams)
    _grad_close(net.offset.weight.grad.numpy().transpose(2, 3, 1, 0),
                dflat["offset.conv.kernel"], f"{mode} doffset")
    _grad_close(net.scope.weight.grad.numpy().transpose(2, 3, 1, 0),
                dflat["scope.conv.kernel"], f"{mode} dscope")


# ---------------------------------------------------------------------------
# DUnet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dunet():
    """The JAX DUnet (num_feat 16), its params plus noise and its spectral
    collection, and the port's DUnet with the same weights and (u, v)."""
    net = jax_build_network({"type": "dunet", "num_feat": NF})
    variables = net.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.05,
                          variables["params"])
    spectral = variables["spectral"]
    flat = {**JaxBaseModel.flatten_params(params),
            **{f"__spectral__.{k}": v
               for k, v in JaxBaseModel.flatten_params(spectral).items()}}
    port = build_network({"type": "dunet", "num_feat": NF})
    port.load_state_dict(state_dict_from_jax(flat, "DUnet"), strict=True)
    return net, params, spectral, port


@pytest.mark.parametrize("train", [True, False])
def test_dunet_forward_and_gradients_match_jax(jax_dunet, train):
    net, params, spectral, port = jax_dunet
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)

    def f(p, xx):
        return net.apply({"params": p, "spectral": spectral}, xx, train=train,
                         return_features=True)

    (want, want_feats), vjp = jax.vjp(f, params, jnp.asarray(x))
    gy = rng.standard_normal(want.shape).astype(np.float32)
    gfeats = [rng.standard_normal(a.shape).astype(np.float32) for a in want_feats]
    dparams, dx = vjp((jnp.asarray(gy), [jnp.asarray(g) for g in gfeats]))

    port = port.train(train)
    port.zero_grad(set_to_none=True)
    xt = _nchw(x).requires_grad_(True)
    got, feats = port(xt, return_features=True)
    assert got.shape == (2, 1, 32, 32)
    _close(_nhwc(got), want, "logits")
    for i, (a, b) in enumerate(zip(feats, want_feats)):
        _close(_nhwc(a), b, f"feature {i}")
    torch.autograd.backward([got, *feats], [_nchw(gy), *[_nchw(g) for g in gfeats]])
    _grad_close(_nhwc(xt.grad), dx, "dx")
    want_g = state_dict_from_jax(JaxBaseModel.flatten_params(dparams), "DUnet")
    named = dict(port.named_parameters())
    assert set(named) == {k for k in want_g if not k.endswith("init_pos")}
    for k, p in named.items():
        _grad_close(p.grad.numpy(), want_g[k].numpy(), k)


# ---------------------------------------------------------------------------
# the weight bridge and the golden fixture
# ---------------------------------------------------------------------------


def test_bridge_round_trip_through_the_jax_converter(jax_dunet):
    """The port's state dict -> JAX `_convert_dunet` -> `state_dict_from_jax`
    gives it back bit for bit; the JAX side holds the same (u, v)."""
    from trainner_redux_tpu.utils.torch_compat import _CONVERTERS

    net, params, spectral, port = jax_dunet
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    flat = _CONVERTERS["dunet"](sd, net)
    back = state_dict_from_jax(flat, "DUnet")
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    want = JaxBaseModel.flatten_params(spectral)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[f"__spectral__.{k}"], v, err_msg=k)


def _load_through_model(tmp_path, path: Path, strict: bool = True):
    """A DUnet loaded by SRModel.load_network from `path`."""
    from trainner_redux_tpu_torch.models.sr_model import SRModel

    model = SRModel.__new__(SRModel)
    from trainner_redux_tpu_torch.utils.logger import get_root_logger

    model.logger = get_root_logger()
    net = build_network({"type": "dunet", "num_feat": NF})
    net.init_weights(torch.Generator().manual_seed(0))
    model.load_network(net, str(path), strict=strict)
    return net


def test_golden_dunet_fixture_through_load_network(tmp_path):
    data = np.load(GOLDEN / "dunet.npz")
    x, y = data["x"], data["y"]
    net = _load_through_model(tmp_path, GOLDEN / "dunet.safetensors").eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == y.shape == (1, 1, 32, 32)
    assert np.abs(got - y).max() < 2e-4 * max(1.0, float(np.abs(y).max()))


def test_legacy_spectral_norm_keys_load(tmp_path):
    """An upstream checkpoint saved with torch's legacy spectral_norm
    (weight_orig / weight_u / weight_v, as a .pth) loads strictly to the
    same network as the parametrization form."""
    from safetensors.numpy import load_file

    sd = load_file(str(GOLDEN / "dunet.safetensors"))
    legacy = {}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original", ".weight_orig")
        k = k.replace(".parametrizations.weight.0._u", ".weight_u")
        k = k.replace(".parametrizations.weight.0._v", ".weight_v")
        legacy[k] = torch.from_numpy(v)
    path = tmp_path / "legacy.pth"
    torch.save(legacy, path)
    a = _load_through_model(tmp_path, path).state_dict()
    b = _load_through_model(tmp_path, GOLDEN / "dunet.safetensors").state_dict()
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_jax_framework_net_d_loads_its_params_and_keeps_u_v(tmp_path, jax_dunet):
    """The JAX package saves net_d's params only; a strict load takes them
    and keeps the network's own (u, v), as the JAX load does."""
    from safetensors.numpy import save_file

    _, params, _, port = jax_dunet
    path = tmp_path / "net_d.safetensors"
    save_file(JaxBaseModel.flatten_params(params), str(path),
              metadata={"framework": "trainner_redux_tpu", "arch": "swinir_m"})
    fresh = build_network({"type": "dunet", "num_feat": NF}).init_weights(
        torch.Generator().manual_seed(0))
    own_uv = {k: v.clone() for k, v in fresh.state_dict().items() if k.endswith(("_u", "_v"))}
    net = _load_through_model(tmp_path, path)
    for k, v in net.state_dict().items():
        want = own_uv[k] if k in own_uv else port.state_dict()[k]
        assert torch.equal(v, want), k
