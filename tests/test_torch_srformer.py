"""Torch port's SRFormer vs the JAX package's, on the CPU (the port's
kernel wrappers run their plain versions).

- the presets `srformer` (embed 180, 6x6, ws 24) and `srformer_light`
  (embed 60, 4x6, ws 16, pixelshuffledirect) have the JAX presets'
  parameter shapes through the weight bridge;
- the bridge: the port's seeded init through the JAX package's own
  `_convert_srformer` and back through `state_dict_from_jax(flat,
  "SRFormer")` bit for bit (tests/test_torch_span.py's `shared_params`),
  and the JAX `_export_srformer` names the port's keys;
- tiny networks in fp32 against the JAX SRFormer: train and eval forwards
  within 1e-4 of the output's largest and the L1 gradients within 1e-4 of
  each tensor's largest: a full-shaped one (embed 24, one layer of 2
  blocks, 2 heads of 12, ws 8: the second block shifted, pixelshuffle) on
  16x16 and on 12x20 (reflect-padded to 16x24), and a light-shaped one
  (3 heads of 8, ws 16, pixelshuffledirect: no shift at 16x16); the
  aligned relative-position index against the JAX one;
- the full-shaped one in bf16 against flax's bf16 (tests/test_torch_span.py's
  `check_bf16`: the output within 2e-2, each gradient's L2 distance from
  the port's fp32 one at most twice flax's plus 1e-2 of its norm), the MLP
  halves on #2/#7's bf16 forms (their calls counted);
- three L1 `SRModel` steps (AdamW, EMA) of the light-shaped net against
  the JAX `SRModel` within 1e-5 (`three_steps_match_jax`, which tests/test_torch_
  atd.py shares).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_span import check_bf16, check_fp32, check_preset, shared_params
from tests.test_torch_train import _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

FULL = {"type": "srformer", "embed_dim": 24, "depths": [2], "num_heads": [2],
        "window_size": 8, "num_feat": 16, "drop_path_rate": 0.0}
LIGHT = {"type": "srformer_light", "embed_dim": 24, "depths": [2], "num_heads": [3],
         "window_size": 16, "drop_path_rate": 0.0}


@pytest.mark.parametrize("preset", ["srformer", "srformer_light"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


def test_bridge_round_trips_and_matches_the_jax_export():
    from trainner_redux_tpu.utils.torch_compat import _export_srformer

    flat, net = shared_params(FULL, 2, "SRFormer")  # bit for bit both ways
    assert set(_export_srformer(flat)) == set(net.state_dict())
    pre = "layers.0.residual_group.blocks.1"
    sd = state_dict_from_jax(flat, "SRFormer")
    for k in (f"{pre}.attn.kv.weight", f"{pre}.attn.relative_position_bias_table",
              f"{pre}.mlp.fc2.bias", "patch_embed.norm.weight", "layers.0.conv.bias",
              "conv_before_upsample.0.weight", "upsample.0.weight", "conv_last.bias"):
        assert k in sd, k


def test_psa_index_matches_jax():
    """The aligned index, its .5 values rounded half to even as numpy's."""
    from trainner_redux_tpu.archs.srformer_arch import _psa_rel_index as jax_index
    from trainner_redux_tpu_torch.archs.srformer_arch import _psa_rel_index

    for ws in (8, 16, 24):
        np.testing.assert_array_equal(_psa_rel_index(ws, ws // 2), jax_index(ws, ws // 2))


@pytest.mark.parametrize(("net", "h", "w"), [(FULL, 16, 16), (FULL, 12, 20), (LIGHT, 16, 16)],
                         ids=["full", "full-padded", "light"])
def test_srformer_matches_jax(net, h, w):
    check_fp32(net, "SRFormer", 2, h, w)


def test_srformer_bf16_matches_flax():
    from trainner_redux_tpu_torch.ops import fused_block as tfb

    n0 = (tfb.fused_ln_mlp_bf16.launches, tfb.fused_ln_mlp_backward_bf16.launches)
    check_bf16(FULL, "SRFormer", 2)
    # on the CPU the bf16 forms run their plain versions, uncounted
    assert (tfb.fused_ln_mlp_bf16.launches, tfb.fused_ln_mlp_backward_bf16.launches) == n0


def three_steps_match_jax(net_opt: dict, arch: str, dataset_root, tmp_path,
                          monkeypatch) -> None:
    """Three L1 SRModel steps (AdamW, EMA, batch 2 of 16x16 LR crops) of the
    port against the JAX SRModel from the same weights: the first step's
    gradients within 1e-4 of each tensor's largest, the logged losses and
    grad norms within 1e-5 relative, the parameters and EMA after three
    steps within 1e-5 (where their gradient is alive)."""
    from safetensors.numpy import save_file

    from tests.test_torch_train import _config
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    flat, _ = shared_params(net_opt, 2, arch)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu"})
    cfg = _config(dataset_root, weights)
    cfg["name"] = f"torch_{arch.lower()}_train_parity"
    cfg["network_g"] = dict(net_opt)
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")

    def to_port(tree) -> dict[str, np.ndarray]:
        flat_tree = JaxBaseModel.flatten_params(tree)
        return {k: np.asarray(v) for k, v in state_dict_from_jax(flat_tree, arch).items()}

    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), to_port(jmodel.state.params_g)[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)} for _ in range(3)]
    grad_fn = jax.jit(jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0]))
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


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    three_steps_match_jax(LIGHT, "SRFormer", dataset, tmp_path, monkeypatch)


class _FakeWriter:
    """Records add_scalar calls (tag, value, step) and close."""

    def __init__(self) -> None:
        self.scalars: list[tuple[str, float, int]] = []
        self.closed = False

    def add_scalar(self, tag, value, step) -> None:
        self.scalars.append((tag, float(value), int(step)))

    def close(self) -> None:
        self.closed = True


def test_train_run_writes_tensorboard_tags(dataset, tmp_path, monkeypatch):  # noqa: F811
    """use_tb_logger: `train.run` opens the writer under tb_logger/<name>
    (a fake one here: torch's SummaryWriter would import TensorFlow) and
    logs the JAX MessageLogger's tags each print and the validation
    metrics; a name holding "debug" opens none."""
    import sys

    from tests.test_torch_train import _config, _yaml
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.utils import logger as port_logger
    from trainner_redux_tpu_torch.utils.options import parse_options

    opened: list[tuple[str, _FakeWriter]] = []

    def fake_init(log_dir):
        opened.append((log_dir, _FakeWriter()))
        return opened[-1][1]

    monkeypatch.setattr(port_logger, "init_tb_logger", fake_init)
    cfg = _config(dataset)
    cfg["name"] = "torch_tb_tags"
    cfg["network_g"] = dict(LIGHT)
    cfg["train"]["total_iter"] = 2
    cfg["logger"]["use_tb_logger"] = True
    cfg["datasets"]["val"] = {"name": "tiny_val", "type": "PairedImageDataset",
                              "dataroot_gt": str(dataset / "hr"),
                              "dataroot_lq": str(dataset / "lr")}
    cfg["val"] = {"val_enabled": True, "val_freq": 2, "save_img": False,
                  "metrics_enabled": True,
                  "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 2}}}
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])
    port_train.run(opt, device="cpu")
    assert len(opened) == 1 and opened[0][0] == str(tmp_path / "tb_logger" / "torch_tb_tags")
    writer = opened[0][1]
    tags = {(tag, step) for tag, _, step in writer.scalars}
    for step in (1, 2):
        assert {("losses/l_g_l1", step), ("losses/l_g_total", step),
                ("gradients/grad_norm_g", step)} <= tags
    assert ("performance/avg_iter_time_sec", 2) in tags
    assert ("performance/throughput_samples_per_sec", 2) in tags
    assert ("loss_balance/l_g_l1_ratio", 1) in tags
    assert ("metrics/tiny_val/psnr", 2) in tags and writer.closed
    assert "tensorflow" not in sys.modules

    cfg["name"] = "debug_torch_tb_tags"
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])
    port_train.run(opt, device="cpu")
    assert len(opened) == 1
