"""Torch port's DAT vs the JAX package's, on the CPU (the port's kernel
wrappers run their plain versions).

- the weight bridge: the golden `dat.safetensors` (a reference-torch DAT)
  through the JAX `_convert_dat`, then `state_dict_from_jax(flat, "DAT")`,
  gives the torch file back less the buffers the port recomputes; the
  presets dat, dat_s, dat_2 and dat_light have the JAX presets' parameter
  shapes, and the repo's DAT test templates build;
- a tiny DAT (embed 96, two residual groups of two blocks, 4 heads, split
  (8, 16), 2x, expansion 2) in eval mode within 1e-4 of the JAX DAT
  (TRAINNER_FUSED_BLOCK=interpret: its Pallas rect kernel in interpret
  mode), on an LR image that fits the windows and one whose qkv is padded,
  through the kernel wrappers (calls counted) and through the plain branch
  (TRAINNER_FUSED_ATTN=0);
- the golden `dat` fixture loaded through `SRModel.load_network`, within
  2e-4 of max |y|;
- three training steps of the tiny DAT (LR 12x12 crops, so qkv is padded to
  16x16; batch 2, L1, AdamW, EMA 0.999, fp32) against the JAX `SRModel`:
  step-1 gradients within 1e-4 of each tensor's largest (where the true
  gradient is 0, both within 1e-5 of the largest of all; where it cancels to
  below 1e-4 of the largest of all, within 1e-4 of that floor), the logged loss and
  gradient norm within 1e-5 relative, params and EMA within 1e-5 (entries
  with a live step-1 gradient, and every BatchNorm running statistic, which
  AdamW's weight decay moves);
- `MSSIMLoss` (and `SSIMLoss`) value and gradient against the JAX losses on
  seeded 2x192x192x3 pairs, within 1e-5.
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
from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.archs.dat_arch import ZERO_GRAD_PARAMS
from trainner_redux_tpu_torch.utils.torch_compat import (
    drop_recomputed_buffers,
    load_torch_state_dict,
    state_dict_from_jax,
)

# its limits were set at torch's default thread count (tests/torch_threads.py)
TORCH_DEFAULT_THREADS = ("test_three_steps_match_jax",)
REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
TINY = {"type": "dat", "embed_dim": 96, "depth": [2, 2], "num_heads": [4, 4],
        "split_size": [8, 16], "expansion_factor": 2.0, "drop_path_rate": 0.0}
# Step-1 gradients whose largest entry is below this share of the largest of
# all (gmax) are sums that nearly cancel: the port's CPU backward of the
# position-bias gather (`index_put_` with accumulate) adds its rows with
# parallel atomic adds, so their last bits change from run to run.
CANCEL_FLOOR = 1e-4
# the golden fixture's config (tests/test_utils/test_golden_parity.py, "dat")
GOLDEN_NET = {"type": "dat", "embed_dim": 16, "depth": [2], "num_heads": [2],
              "split_size": [2, 4], "drop_path_rate": 0.0}


def _lr(seed=0, h=16, w=32):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _jax_flat(scale: int, noise: float = 0.02):
    """The tiny DAT's JAX params, init plus noise (so every LayerNorm and
    BatchNorm affine, running statistic and bias moves a real value through
    the bridge)."""
    net = jax_build_network({**TINY, "scale": scale})
    params = net.init(jax.random.key(0), jnp.asarray(_lr()), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * noise).astype(np.float32)
            for k, v in JaxBaseModel.flatten_params(params).items()}
    return net, flat


def _to_port(tree) -> dict[str, np.ndarray]:
    flat = JaxBaseModel.flatten_params(tree)
    return {k: np.asarray(v) for k, v in state_dict_from_jax(flat, "DAT").items()}


def test_golden_bridge_round_trip():
    """torch file -> JAX `_convert_dat` -> the port's bridge: the torch file
    again, less the recomputed buffers, with the 0-element position-MLP
    layers of the tiny widths restored."""
    from trainner_redux_tpu.utils.torch_compat import _convert_dat

    sd = load_torch_state_dict(str(GOLDEN / "dat.safetensors"))
    jnet = jax_build_network({**GOLDEN_NET, "scale": 2})
    back = state_dict_from_jax(_convert_dat(dict(sd), jnet), "DAT")
    want = drop_recomputed_buffers(sd)
    assert set(back) == set(want)
    assert set(back) == set(build_network({**GOLDEN_NET, "scale": 2}).state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    dropped = set(sd) - set(want)
    assert any(k.endswith("rpe_biases") for k in dropped)
    assert any(k.endswith("num_batches_tracked") for k in dropped)
    assert "layers.0.blocks.0.attn.dwconv.1.running_var" in back
    assert back["layers.0.blocks.0.attn.attns.0.pos.pos_proj.weight"].shape == (0, 2)


def test_tiny_bridge_keys_are_the_official_ones():
    _, flat = _jax_flat(2)
    sd = state_dict_from_jax(flat, "DAT")
    assert set(sd) == set(build_network({**TINY, "scale": 2}).state_dict())
    assert "layers.1.blocks.0.attn.attns.1.pos.pos2.0.weight" in sd
    assert "layers.0.blocks.1.attn.temperature" in sd
    assert "layers.0.blocks.0.ffn.sg.conv.weight" in sd


@pytest.mark.parametrize("preset", ["dat", "dat_s", "dat_2", "dat_light"])
def test_presets_match_jax_param_shapes(preset):
    """Every preset's parameters, through the bridge, have the port's keys
    and shapes (JAX shapes from eval_shape: nothing is initialised)."""
    net = jax_build_network({"type": preset, "scale": 4})
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False))["params"]
    flat = {".".join(p.key for p in path): np.empty(s.shape, np.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(flat, "DAT").items()}
    port = build_network({"type": preset, "scale": 4})
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}


@pytest.mark.parametrize("preset", ["dat", "dat_s", "dat_2", "dat_light"])
def test_dat_test_templates_build(preset):
    """The repo's DAT test templates decode strictly and build in the port."""
    from trainner_redux_tpu_torch.utils.options import yaml_load

    templates = REPO / "configs" / "_templates" / "test" / "DAT"
    opt, _ = yaml_load(str(templates / f"{preset}_test.yml"))
    net = build_network({**opt.network_g, "scale": opt.scale})
    assert net.upscale == opt.scale == 4
    assert sum(p.numel() for p in net.parameters()) > 0


@pytest.mark.parametrize("size", [(16, 32), (20, 24)])
@pytest.mark.parametrize("branch", ["kernels", "plain"])
def test_dat_matches_jax(branch, size, monkeypatch):
    """(16, 32) fits the windows; (20, 24) pads qkv to 32x32. The first
    group's spatial block is unshifted (K=1), the second's shifted (K=4)."""
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    jnet, flat = _jax_flat(2)
    lr = _lr(2, *size)
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))

    if branch == "plain":
        monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
    from trainner_redux_tpu_torch.ops import window_attention as wa

    calls = []
    real = wa._RectMhsa.apply

    def counted(*a):
        calls.append(tuple(a[4:]))
        return real(*a)

    monkeypatch.setattr(wa._RectMhsa, "apply", counted)
    net = build_network({**TINY, "scale": 2})
    net.load_state_dict(state_dict_from_jax(flat, "DAT"), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    # two spatial blocks of two branches each, in both orientations, or none
    assert calls == ([(8, 16), (16, 8)] * 2 if branch == "kernels" else [])
    assert got.shape == want.shape == (1, 2 * size[0], 2 * size[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_golden_dat_fixture_through_load_network(tmp_path, monkeypatch):
    """The reference-torch DAT's own checkpoint (with its rpe_biases,
    relative_position_index and num_batches_tracked buffers, and 0-element
    position-MLP layers) loads strictly through SRModel.load_network and
    reproduces the reference output."""
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    data = np.load(GOLDEN / "dat.npz")
    x, y = data["x"], data["y"]
    raw = {
        "name": "golden_dat", "scale": 2, "num_gpu": 1, "network_g": dict(GOLDEN_NET),
        "path": {"pretrain_network_g": str(GOLDEN / "dat.safetensors"), "strict_load_g": True},
    }
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    model = build_model(opt, device="cpu")
    with torch.no_grad():
        got = model.net_g(torch.from_numpy(x)).numpy()
    assert got.shape == y.shape == (1, 3, 32, 32)
    assert np.abs(got - y).max() <= 2e-4 * np.abs(y).max()


def test_batchnorm_no_stats_semantics():
    """Batch statistics (biased variance) and no running update in train
    mode, the stored statistics in eval mode; all four are parameters."""
    from trainner_redux_tpu_torch.archs.dat_arch import BatchNormNoStats

    bn = BatchNormNoStats(3)
    assert {n for n, _ in bn.named_parameters()} == {"weight", "bias", "running_mean",
                                                     "running_var"}
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([1.0, 2.0, 3.0]))
        bn.running_var.copy_(torch.tensor([4.0, 1.0, 0.25]))
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    y = bn.train()(x)
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    torch.testing.assert_close(y, (x - mu) / torch.sqrt(var + 1e-5))
    assert bn.running_mean.tolist() == [1.0, 2.0, 3.0]
    y = bn.eval()(x)
    torch.testing.assert_close(y, (x - bn.running_mean.view(1, 3, 1, 1))
                               / torch.sqrt(bn.running_var.view(1, 3, 1, 1) + 1e-5))


def _config(dataset_root: Path, weights: Path) -> dict:
    from tests.test_torch_train import _config as swinir_config

    cfg = swinir_config(dataset_root, weights)
    cfg["name"] = "torch_dat_train_parity"
    cfg["network_g"] = dict(TINY)
    cfg["datasets"]["train"]["lq_size"] = 12
    return cfg


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(2)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "dat"})
    jopt, opt = _opts(tmp_path, _config(dataset, weights))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")

    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), _to_port(jmodel.state.params_g)[k], err_msg=k)

    from trainner_redux_tpu_torch.ops import window_attention as wa

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 12, 12, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)} for _ in range(3)]
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    want_g = _to_port(grad_fn(jmodel.state.params_g,
                              jnp.asarray(batches[0]["lq"], jnp.float32) / 255.0,
                              jnp.asarray(batches[0]["gt"], jnp.float32) / 255.0))

    calls = {"fwd": 0, "bwd": 0}
    real_bwd = wa.fused_rect_mhsa_backward

    def counted_bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(wa, "fused_rect_mhsa_backward", counted_bwd)
    real_fwd = wa._RectMhsa.apply

    def counted_fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    monkeypatch.setattr(wa._RectMhsa, "apply", counted_fwd)
    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            # two spatial blocks of two branches, through the wrapper both ways
            assert calls == {"fwd": 4, "bwd": 4}
            got_g = {k: p.grad.numpy() for k, p in model.net_g.named_parameters()}
            assert set(got_g) == set(want_g)
            gmax = max(np.abs(w).max() for w in want_g.values())
            for k, w in want_g.items():
                if k.endswith(ZERO_GRAD_PARAMS):  # rounding noise in both, near 0
                    assert max(np.abs(w).max(), np.abs(got_g[k]).max()) <= 1e-5 * gmax, k
                    continue
                # a gradient that cancels to below CANCEL_FLOOR of gmax (the
                # position MLPs': its sums carry rounding noise of gmax's
                # terms) is held at 1e-4 of that floor, every other at 1e-4
                # of its own largest
                ref = max(np.abs(w).max(), CANCEL_FLOOR * gmax)
                err = np.abs(got_g[k] - w).max()
                assert err <= 1e-4 * ref, f"{k}: {err:.3g} vs {np.abs(w).max():.3g}"
        for key in ("l_g_l1", "l_g_total", "grad_norm_g"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {i}")

    gmax = max(np.abs(w).max() for w in want_g.values())
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        for k, v in net.state_dict().items():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            if k.endswith(("running_mean", "running_var")):
                live[...] = True  # no gradient: weight decay alone moves them
            err = np.abs(v.numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"


@pytest.mark.parametrize("loss", [
    {"type": "mssimloss"},
    {"type": "mssimloss", "loss_weight": 0.5, "is_prod": False, "color_space": "ycbcr"},
    {"type": "ssimloss", "crop_border": 4},
])
def test_ssim_losses_match_jax(loss):
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu.losses import loss_log_key as jkey
    from trainner_redux_tpu_torch.losses import build_loss, loss_log_key

    rng = np.random.default_rng(3)
    a = rng.random((2, 192, 192, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0.0, 1.0).astype(np.float32)
    jl = jbuild(dict(loss))
    want, want_g = jax.value_and_grad(lambda x: jl(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).requires_grad_()
    port = build_loss(dict(loss))
    got = port(x, torch.from_numpy(b.transpose(0, 3, 1, 2).copy()))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), np.asarray(want_g),
                               atol=1e-5, rtol=0)
    assert loss_log_key(port, loss["type"]) == jkey(jl, loss["type"])
