"""Torch port's Swin2SR vs the JAX package's, on the CPU (the port's kernel
wrappers run their plain versions).

- the presets swin2sr_s, swin2sr_m and swin2sr_l have the JAX presets'
  parameter shapes through the weight bridge, and the repo's Swin2SR test
  templates build;
- the bridge: `state_dict_from_jax(flat, "Swin2SR")` loads strictly, and the
  JAX `_convert_swin2sr` takes the port's state dict back to the same flat
  parameters;
- a tiny Swin2SR (embed 24, one group of two blocks, 3 heads of 8, window
  8, 4x) in eval mode within 1e-4 of the JAX Swin2SR, with the JAX side
  under TRAINNER_FUSED_BLOCK=interpret (its Pallas kernels #11/#13 in
  interpret mode) and =0 (its unfused modules), the port's side through
  its kernel wrappers (calls counted) and its unfused branch; on a 16x24
  LR image (the second block shifted) and a 12x20 one (reflect-padded);
- an upstream-layout state dict (`q_bias`, `v_bias`, `relative_coords_table`,
  `relative_position_index`, `attn_mask`) loaded through
  `SRModel.load_network` gives the output of the JAX Swin2SR loaded through
  the JAX `_convert_swin2sr`, within 1e-4;
- three training steps of the tiny Swin2SR (4x, batch 2 of 48x48 LR, L1 +
  MS-SSIM, AdamW, EMA 0.999, drop-path 0, fp32) against the JAX `SRModel`
  under TRAINNER_FUSED_BLOCK=interpret: step-1 gradients within 1e-4 of
  each tensor's largest, the logged losses and gradient norm within 1e-5
  relative, params and EMA within 1e-5 (entries with a live step-1
  gradient, as in tests/test_torch_train.py);
- the routing of a block too large for the training kernels (Swin2SR-L's
  widths): the unfused branch in training, the kernels at eval.
"""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _opts
from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TINY = {"type": "swin2sr_m", "embed_dim": 24, "depths": [2], "num_heads": [3], "num_feat": 16,
        "drop_path_rate": 0.0}


def _lr(seed=0, h=16, w=24):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _jax_flat(noise: float = 0.05):
    """The tiny Swin2SR's JAX params (4x), init plus noise (so every
    LayerNorm affine, bias and logit_scale moves a real value through the
    bridge)."""
    net = jax_build_network({**TINY, "scale": 4})
    params = net.init(jax.random.key(0), jnp.asarray(_lr()), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * noise).astype(np.float32)
            for k, v in JaxBaseModel.flatten_params(params).items()}
    return net, flat


def _jax_apply(jnet, flat, lr):
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))


def _to_port(tree) -> dict[str, np.ndarray]:
    flat = JaxBaseModel.flatten_params(tree)
    return {k: np.asarray(v) for k, v in state_dict_from_jax(flat, "Swin2SR").items()}


@pytest.mark.parametrize("preset", ["swin2sr_s", "swin2sr_m", "swin2sr_l"])
def test_presets_match_jax_param_shapes(preset):
    """Every preset's parameters, through the bridge, have the port's keys
    and shapes (JAX shapes from eval_shape: nothing is initialised)."""
    net = jax_build_network({"type": preset, "scale": 4})
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False))["params"]
    flat = {".".join(p.key for p in path): np.empty(s.shape, np.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(flat, "Swin2SR").items()}
    port = build_network({"type": preset, "scale": 4})
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}


@pytest.mark.parametrize("preset", ["swin2sr_s", "swin2sr_m", "swin2sr_l"])
def test_swin2sr_test_templates_build(preset):
    """The repo's Swin2SR test templates decode strictly and build in the port."""
    from trainner_redux_tpu_torch.utils.options import yaml_load

    templates = REPO / "configs" / "_templates" / "test" / "Swin2SR"
    opt, _ = yaml_load(str(templates / f"{preset}_test.yml"))
    net = build_network({**opt.network_g, "scale": opt.scale})
    assert net.upscale == opt.scale == 4
    assert sum(p.numel() for p in net.parameters()) > 0


def test_bridge_loads_strictly_and_round_trips_through_the_jax_converter():
    from trainner_redux_tpu.utils.torch_compat import _convert_swin2sr

    jnet, flat = _jax_flat()
    sd = state_dict_from_jax(flat, "Swin2SR")
    net = build_network({**TINY, "scale": 4})
    net.load_state_dict(sd, strict=True)
    assert "layers.0.residual_group.blocks.1.attn.cpb_mlp.2.weight" in sd
    assert "patch_embed.norm.weight" in sd and "upsample.2.bias" in sd
    back = _convert_swin2sr({k: v.numpy() for k, v in sd.items()}, jnet)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize(("branch", "jax_mode", "size"), [
    ("kernels", "interpret", (16, 24)), ("kernels", "0", (16, 24)),
    ("unfused", "interpret", (16, 24)), ("unfused", "0", (16, 24)),
    ("kernels", "interpret", (12, 20)),  # reflect-padded to 16x24
])
def test_swin2sr_matches_jax(branch, jax_mode, size, monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", jax_mode)
    jnet, flat = _jax_flat()
    lr = _lr(2, *size)
    want = _jax_apply(jnet, flat, lr)

    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "1" if branch == "kernels" else "0")
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    calls = {"attn": 0, "mlp": 0}
    real_attn, real_mlp = v2._CosAttn.apply, v2._PostnormMlp.apply

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(v2._CosAttn, "apply", count("attn", real_attn))
    monkeypatch.setattr(v2._PostnormMlp, "apply", count("mlp", real_mlp))
    net = build_network({**TINY, "scale": 4})
    net.load_state_dict(state_dict_from_jax(flat, "Swin2SR"), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert calls == ({"attn": 2, "mlp": 2} if branch == "kernels" else {"attn": 0, "mlp": 0})
    assert got.shape == want.shape == (1, 4 * size[0], 4 * size[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _upstream_layout(sd: dict) -> dict:
    """A port state dict in upstream Swin2SR's layout: each qkv bias split
    into q_bias and v_bias (upstream has no k bias), with the buffers
    upstream checkpoints carry."""
    out = {k: v.clone() for k, v in sd.items()}
    for k in [k for k in out if k.endswith("attn.qkv.bias")]:
        bias = out.pop(k)
        c, pre = bias.shape[0] // 3, k.removesuffix("qkv.bias")
        out[f"{pre}q_bias"], out[f"{pre}v_bias"] = bias[:c].clone(), bias[2 * c :].clone()
        out[f"{pre}relative_coords_table"] = torch.zeros(1, 15, 15, 2)
        out[f"{pre}relative_position_index"] = torch.zeros(64, 64, dtype=torch.int64)
        if ".blocks.1." in k:
            out[k.replace("attn.qkv.bias", "attn_mask")] = torch.zeros(6, 64, 64)
    return out


def test_upstream_checkpoint_through_load_network(tmp_path, monkeypatch):
    from trainner_redux_tpu.utils.torch_compat import _convert_swin2sr
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    jnet, flat = _jax_flat()
    upstream = _upstream_layout(state_dict_from_jax(flat, "Swin2SR"))
    path = tmp_path / "swin2sr_upstream.pth"
    torch.save(upstream, path)
    lr = _lr(3)
    want = _jax_apply(jnet, _convert_swin2sr({k: v.numpy() for k, v in upstream.items()}, jnet),
                      lr)

    raw = {"name": "upstream_swin2sr", "scale": 4, "num_gpu": 1, "network_g": dict(TINY),
           "path": {"pretrain_network_g": str(path), "strict_load_g": True}}
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    model = build_model(opt, device="cpu")
    qkv_bias = model.net_g.state_dict()["layers.0.residual_group.blocks.0.attn.qkv.bias"]
    assert torch.equal(qkv_bias[24:48], torch.zeros(24))  # the k bias: 0, as upstream's
    with torch.no_grad():
        got = model.net_g(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 random 192x192 HR images and their 4x box-down 48x48 LR: the
    template's LR crop, and large enough for MS-SSIM's five scales."""
    root = tmp_path_factory.mktemp("swin2sr_ds")
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        hr = (rng.random((192, 192, 3)) * 255).astype(np.uint8)
        lr = hr.reshape(48, 4, 48, 4, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(root / "hr" / f"img{i}.png"), hr)
        cv2.imwrite(str(root / "lr" / f"img{i}.png"), lr)
    return root


def _config(dataset_root: Path, weights: Path) -> dict:
    from tests.test_torch_train import _config as swinir_config

    cfg = swinir_config(dataset_root, weights)
    cfg["name"] = "torch_swin2sr_train_parity"
    cfg["scale"] = 4
    cfg["network_g"] = dict(TINY)
    cfg["datasets"]["train"]["lq_size"] = 48
    cfg["train"]["losses"] = [{"type": "l1loss", "loss_weight": 1.0},
                              {"type": "mssimloss", "loss_weight": 1.0}]
    return cfg


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(noise=0.02)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "swin2sr"})
    jopt, opt = _opts(tmp_path, _config(dataset, weights))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), _to_port(jmodel.state.params_g)[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)} for _ in range(3)]
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    want_g = _to_port(grad_fn(jmodel.state.params_g,
                              jnp.asarray(batches[0]["lq"], jnp.float32) / 255.0,
                              jnp.asarray(batches[0]["gt"], jnp.float32) / 255.0))

    backwards = {"attn": 0, "mlp": 0}
    for key, name in (("attn", "fused_cos_attn_block_backward"),
                      ("mlp", "fused_postnorm_mlp_backward")):
        real = getattr(v2, name)

        def counted(*a, _real=real, _key=key):
            backwards[_key] += 1
            return _real(*a)

        monkeypatch.setattr(v2, name, counted)
    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            assert backwards == {"attn": 2, "mlp": 2}  # two blocks, through the wrappers
            got_g = {k: p.grad.numpy() for k, p in model.net_g.named_parameters()}
            assert set(got_g) == set(want_g)
            for k, w in want_g.items():
                err = np.abs(got_g[k] - w).max()
                assert err <= 1e-4 * np.abs(w).max(), f"{k}: {err:.3g} vs {np.abs(w).max():.3g}"
        assert {"l_g_l1", "l_g_mssim", "l_g_total"} <= set(log)
        for key in ("l_g_l1", "l_g_mssim", "l_g_total", "grad_norm_g"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {i}")

    gmax = max(np.abs(w).max() for w in want_g.values())
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        for k, v in net.state_dict().items():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            err = np.abs(v.numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"


def test_a_block_too_large_for_the_training_kernels_trains_unfused(monkeypatch):
    """Swin2SR-L's block (C 240, 8 heads of 30, hidden 480): #14's plan has
    no room, so in training it takes the unfused branch (no kernel wrapper),
    which computes the same function; at eval, and at Swin2SR-M's widths in
    training, it takes the kernels."""
    from trainner_redux_tpu_torch.archs.swin2sr_arch import Swin2Block
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    calls = []
    real = v2._CosAttn.apply

    def counted(*a):
        calls.append(a[0].shape[-1])
        return real(*a)

    monkeypatch.setattr(v2._CosAttn, "apply", counted)
    gen = torch.Generator().manual_seed(0)
    for dim, heads, mode, want in ((240, 8, "train", []), (240, 8, "eval", [240]),
                                   (180, 6, "train", [180])):
        calls.clear()
        blk = Swin2Block(dim, heads, 8, 4, 2.0)
        blk.train(mode == "train")
        x = torch.randn(1, 16, 16, dim, generator=gen)
        out = blk(x)
        assert calls == want, (dim, mode)
        if mode == "train":  # both branches give the same block
            monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
            torch.testing.assert_close(blk(x), out, atol=1e-5, rtol=1e-5)
            monkeypatch.delenv("TRAINNER_FUSED_BLOCK")
