"""Torch port's DRCT against the JAX package's, on the CPU (the port's
kernel wrappers run their plain versions).

- the preset `drct` has the JAX preset's parameter shapes through the
  weight bridge, and `drct_l` and `drct_xl` the JAX presets' groups and
  widths; drct's group follows the head rule (heads of 30, 53, 122, 46, 77);
- the bridge: the port's seeded init through the JAX package's own
  `_convert_drct` and back through `state_dict_from_jax(flat, "DRCT")` bit
  for bit (tests/test_torch_span.py's `shared_params`), upstream's key
  names (`layers.0.swin3.mlp.fc1.weight`, `layers.0.adjust5.weight`, ...);
- the golden `drct` config (embed 18, one group, 2 heads, ws 4, growth 6:
  widths 18-42, the second and fourth blocks shifted, the last two at MLP
  ratio 1) against the JAX DRCT in fp32: train and eval forwards within
  1e-4 of the output's largest and the L1 gradients within 1e-4 of each
  tensor's largest, on 16x16; and a one-group net at 16x16 windows on 20x28
  (reflect-padded to 32x32), every block's attention on
  `fused_window_mhsa` and its MLP on `fused_ln_mlp` (their plain versions
  here: the kernels' gates take its blocks);
- the golden fixture (an upstream DRCT checkpoint and its outputs,
  tests/test_utils/test_golden_parity.py) strictly through
  `SRModel.load_network` within 2e-4, and a JAX-framework file of the same
  network;
- bf16 and the 9 templates: tests/test_torch_drct_bf16.py; three
  `SRModel` steps: tests/test_torch_drct_steps.py.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_span import (
    GOLDEN_TOL,
    check_fp32,
    check_golden,
    check_preset,
    shared_params,
)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

# the golden fixture's config (tests/test_utils/test_golden_parity.py)
GOLDEN = {"type": "drct", "embed_dim": 18, "depths": [2], "num_heads": [2], "window_size": 4,
          "growth": 6, "drop_path_rate": 0.0}
# one group whose blocks take the unfused branch's kernel wrappers, as the
# presets' do: 16x16 windows, widths 24 to 56 (multiples of 4), heads of 12
# to 28
ROUTED = {"type": "drct", "embed_dim": 24, "depths": [2], "num_heads": [2], "window_size": 16,
          "growth": 8, "drop_path_rate": 0.0}


def test_preset_matches_jax_param_shapes():
    check_preset("drct")


@pytest.mark.parametrize("preset", ["drct", "drct_l", "drct_xl"])
def test_presets_match_the_jax_presets(preset):
    """Each preset's configuration as the JAX factory makes it (drct_l's
    and drct_xl's groups are drct's, 12 and 14 of them)."""
    from trainner_redux_tpu.archs import build_network as jax_build_network
    from trainner_redux_tpu_torch.archs import build_network

    jnet = jax_build_network({"type": preset, "scale": 4})
    with torch.device("meta"):
        net = build_network({"type": preset, "scale": 4})
    assert len(net.layers) == len(jnet.num_heads) == {"drct": 6, "drct_l": 12, "drct_xl": 14}[
        preset]
    assert net.window_size == jnet.window_size == 16
    group = net.layers[-1]
    assert group.swin1.dim == jnet.embed_dim and group.adjust1.out_channels == jnet.growth
    assert group.swin1.mlp.fc1.out_features == int(jnet.embed_dim * jnet.mlp_ratio)
    assert group.swin1.drop_path == pytest.approx(jnet.drop_path_rate)


def test_preset_blocks_follow_the_head_rule():
    """drct's group: widths 180 + 32 k, heads 6, 4, 2, 6, 4 (heads of 30,
    53, 122, 46 and 77 channels), MLP ratio 1 in the last two blocks,
    shifts on the second and fourth."""
    from trainner_redux_tpu_torch.archs import build_network

    with torch.device("meta"):
        net = build_network({"type": "drct", "scale": 4})
    group = net.layers[0]
    blocks = [getattr(group, f"swin{i}") for i in range(1, 6)]
    assert [b.dim for b in blocks] == [180, 212, 244, 276, 308]
    assert [b.dim // b.num_heads for b in blocks] == [30, 53, 122, 46, 77]
    assert [b.mlp.fc1.out_features for b in blocks] == [360, 424, 488, 276, 308]
    assert [b.shift_size for b in blocks] == [0, 8, 0, 8, 0]
    assert len(net.layers) == 6 and [b.drop_path for b in blocks] == [0.0] * 5
    assert net.layers[5].swin1.drop_path == pytest.approx(0.1)


def test_bridge_round_trips_with_upstream_keys():
    flat, net = shared_params(GOLDEN, 2, "DRCT")  # bit for bit both ways
    sd = state_dict_from_jax(flat, "DRCT")
    assert set(sd) == {k for k, _ in net.named_parameters()}
    for k in ("layers.0.swin1.attn.qkv.weight", "layers.0.swin2.attn.relative_position_bias_table",
              "layers.0.swin5.mlp.fc2.bias", "layers.0.swin4.norm2.weight",
              "layers.0.adjust1.weight", "layers.0.adjust5.bias", "patch_embed.norm.weight",
              "norm.bias", "conv_after_body.weight", "conv_before_upsample.0.weight",
              "upsample.0.weight", "conv_last.bias"):
        assert k in sd, k
    assert tuple(sd["layers.0.adjust5.weight"].shape) == (18, 42, 1, 1)


def test_drct_matches_jax():
    check_fp32(GOLDEN, "DRCT", 2, 16, 16)


def test_drct_on_the_kernel_wrappers_matches_jax(monkeypatch):
    """ROUTED (16x16 windows, widths multiples of 4) on 20x28, reflect-padded
    to 32x32 (the shifted blocks keep their shift): every block's attention
    takes `fused_window_mhsa` and its MLP `fused_ln_mlp` (their plain
    versions here), in training and at eval."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    calls = {"attn": 0, "mlp": 0}
    real_attn, real_mlp = wa.fused_window_mhsa_reference, fb.fused_ln_mlp_reference

    def attn(*a, **k):
        calls["attn"] += 1
        return real_attn(*a, **k)

    def mlp(*a, **k):
        calls["mlp"] += 1
        return real_mlp(*a, **k)

    monkeypatch.setattr(wa, "fused_window_mhsa_reference", attn)
    monkeypatch.setattr(fb, "fused_ln_mlp_reference", mlp)
    check_fp32(ROUTED, "DRCT", 2, 20, 28)
    # a train and an eval forward of five blocks each
    assert calls == {"attn": 10, "mlp": 10}, calls


def test_golden_fixture_through_load_network(tmp_path):
    assert GOLDEN_TOL == 2e-4
    check_golden(tmp_path, "drct", {**GOLDEN, "scale": 2}, "DRCT")
