"""Torch port's HAT vs the JAX package's, on the CPU (the port's kernel
wrappers run their plain versions).

- the weight bridge: `state_dict_from_jax(flat, "HAT")` gives the port's
  keys, and the JAX `_export_hat` mapping's keys and values; the presets
  hat_s, hat_m and hat_l have the JAX presets' parameter shapes;
- a tiny HAT (embed 24, 2 heads of 12, window 8, one residual group of two
  HABs and an OCAB, 4x) in eval mode on a 16x16 LR image, where the second
  HAB's shift is active, within 1e-4 of the JAX HAT, through the kernel
  wrappers and through the plain branch (TRAINNER_FUSED_ATTN=0);
- the golden `hat` fixture (a reference-torch HAT and its output, window 4)
  loaded through `SRModel.load_network`, within 2e-4 of max |y|;
- three training steps of a tiny HAT (scale 2, LR 16x16, batch 2, L1,
  AdamW, EMA 0.999, fp32) against the JAX `SRModel` under
  TRAINNER_FUSED_BLOCK=interpret (its MLP halves through the Pallas kernels
  in interpret mode): step-1 gradients within 1e-4 of each tensor's
  largest, the logged loss and gradient norm within 1e-5 relative, params
  and EMA within 1e-5 (entries with a live step-1 gradient, as in
  tests/test_torch_train.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu.utils.torch_compat import export_torch_state_dict
from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.utils.torch_compat import _hat_key, state_dict_from_jax

GOLDEN = Path(__file__).resolve().parent / "golden"
TINY = {"type": "hat", "embed_dim": 24, "depths": [2], "num_heads": [2], "window_size": 8,
        "mlp_ratio": 2.0, "compress_ratio": 3, "squeeze_factor": 8, "num_feat": 16,
        "drop_path_rate": 0.0}


def _lr(seed=0, h=16, w=16):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _jax_flat(scale: int, noise: float = 0.05):
    """The tiny HAT's JAX params, init plus noise (so every LayerNorm affine
    and bias moves a real value through the bridge)."""
    net = jax_build_network({**TINY, "scale": scale})
    params = net.init(jax.random.key(0), jnp.asarray(_lr()), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * noise).astype(np.float32)
            for k, v in JaxBaseModel.flatten_params(params).items()}
    return net, flat


def test_state_dict_keys_match_official_export():
    _, flat = _jax_flat(4)
    sd = state_dict_from_jax(flat, "HAT")
    net = build_network({**TINY, "scale": 4})
    assert set(sd) == set(net.state_dict())
    exported = export_torch_state_dict(flat, "HAT")
    assert set(sd) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert "layers.0.residual_group.blocks.1.conv_block.cab.3.attention.3.weight" in sd
    assert "layers.0.residual_group.overlap_attn.relative_position_bias_table" in sd


@pytest.mark.parametrize("preset", ["hat_s", "hat_m", "hat_l"])
def test_presets_match_jax_param_shapes(preset):
    """Every preset's parameters, through the bridge, have the port's keys
    and shapes (JAX shapes from eval_shape: nothing is initialised)."""
    net = jax_build_network({"type": preset, "scale": 4})
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False))["params"]
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        k = ".".join(p.key for p in path)
        key, arr = _hat_key(k, np.empty(s.shape, np.float32))
        want[key] = tuple(arr.shape)
    port = build_network({"type": preset, "scale": 4})
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}


@pytest.mark.parametrize("branch", ["kernels", "plain"])
def test_hat_matches_jax(branch, monkeypatch):
    for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN"):
        monkeypatch.delenv(k, raising=False)
    jnet, flat = _jax_flat(4)
    lr = _lr(seed=2)
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))

    if branch == "plain":
        monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    calls = {"attn": 0, "mlp": 0}
    real_attn, real_mlp = wa._WindowMhsa.apply, fb._LnMlp.apply

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(wa._WindowMhsa, "apply", count("attn", real_attn))
    monkeypatch.setattr(fb._LnMlp, "apply", count("mlp", real_mlp))
    net = build_network({**TINY, "scale": 4})
    net.load_state_dict(state_dict_from_jax(flat, "HAT"), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    # two HABs' attention and three MLP halves (two HABs, one OCAB), or none
    assert calls == ({"attn": 2, "mlp": 3} if branch == "kernels" else {"attn": 0, "mlp": 0})
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_golden_hat_fixture_through_load_network(tmp_path, monkeypatch):
    """The reference-torch HAT's own checkpoint (with its
    relative_position_index_SA / _OCA buffers) loads strictly through
    SRModel.load_network and reproduces the reference output."""
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    data = np.load(GOLDEN / "hat.npz")
    x, y = data["x"], data["y"]
    raw = {
        "name": "golden_hat", "scale": 2, "num_gpu": 1,
        # the fixture's config (tests/test_utils/test_golden_parity.py, "hat")
        "network_g": {"type": "hat", "embed_dim": 16, "depths": [2], "num_heads": [2],
                      "window_size": 4, "compress_ratio": 2, "squeeze_factor": 4,
                      "drop_path_rate": 0.0, "num_feat": 16},
        "path": {"pretrain_network_g": str(GOLDEN / "hat.safetensors"), "strict_load_g": True},
    }
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    model = build_model(opt, device="cpu")
    with torch.no_grad():
        got = model.net_g(torch.from_numpy(x)).numpy()
    assert got.shape == y.shape == (1, 3, 32, 32)
    assert np.abs(got - y).max() <= 2e-4 * np.abs(y).max()


def _config(dataset_root: Path, weights: Path) -> dict:
    from tests.test_torch_train import _config as swinir_config

    cfg = swinir_config(dataset_root, weights)
    cfg["name"] = "torch_hat_train_parity"
    cfg["network_g"] = dict(TINY)
    return cfg


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(2, noise=0.02)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "hat"})
    jopt, opt = _opts(tmp_path, _config(dataset, weights))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")

    def to_port(tree) -> dict[str, np.ndarray]:
        flat_tree = JaxBaseModel.flatten_params(tree)
        return {k: np.asarray(v) for k, v in state_dict_from_jax(flat_tree, "HAT").items()}

    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), to_port(jmodel.state.params_g)[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)} for _ in range(3)]
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    want_g = to_port(grad_fn(jmodel.state.params_g,
                             jnp.asarray(batches[0]["lq"], jnp.float32) / 255.0,
                             jnp.asarray(batches[0]["gt"], jnp.float32) / 255.0))

    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            got_g = {k: p.grad.numpy() for k, p in model.net_g.named_parameters()}
            assert set(got_g) == set(want_g)
            for k, w in want_g.items():
                err = np.abs(got_g[k] - w).max()
                assert err <= 1e-4 * np.abs(w).max(), f"{k}: {err:.3g} vs {np.abs(w).max():.3g}"
        for key in ("l_g_l1", "l_g_total", "grad_norm_g"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {i}")

    gmax = max(np.abs(w).max() for w in want_g.values())
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = to_port(jparams)
        for k, v in net.state_dict().items():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            err = np.abs(v.numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"
