"""Torch port's SRFormerV2 vs the JAX package's, on the CPU (the port's
kernel wrappers run their plain versions).

- the preset `srformerv2` has the JAX preset's parameter shapes through the
  weight bridge, and the repo's SRFormerV2 test template builds;
- the bridge: `state_dict_from_jax(flat, "SRFormerV2")` loads strictly, and
  the JAX `_convert_srformerv2` takes the port's state dict back to the same
  flat parameters (PSA's table inside `attn`, the Swin blocks' at block
  level, the depthwise conv as `mlp.dwconv.depthwise_conv.0`);
- the golden `srformerv2` fixture (a reference-torch SRFormerV2 with its
  index buffers and shift mask) through `SRModel.load_network`, within the
  JAX golden test's tolerance: 2e-4 scaled by max(1, max |y|);
- a tiny SRFormerV2 (embed 32, one layer of 2 PSA blocks and 3 Swin blocks,
  2 heads, window 12, squeeze 8, img_size 24, 2x) in eval mode within 1e-4
  of the JAX SRFormerV2, with the JAX side under TRAINNER_FUSED_BLOCK=
  interpret (its Pallas kernels #1/#2 in interpret mode) and =0 (its plain
  modules), the port's side through its kernel wrappers (calls counted) and
  its plain branch; on a 24x24 LR image and a 20x18 one (reflect-padded to
  24x24);
- the routing of a Swin block whose MLP backward has no plan (C 300,
  hidden 300): the plain branch in training, the kernels at eval; at
  SRFormerV2's widths (C 240, hidden 480) the kernels both ways.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.archs import build_network as jax_build_network
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
TINY = {"type": "srformerv2", "embed_dim": 32, "depths": [2], "num_heads": [2],
        "window_size": 12, "squeeze_dim": 8, "img_size": 24, "num_feat": 16}
# the golden fixture's config (tests/test_utils/test_golden_parity.py, "srformerv2")
GOLDEN_NET = {"type": "srformerv2", "embed_dim": 16, "depths": [2], "num_heads": [2],
              "window_size": 12, "squeeze_dim": 8, "img_size": 12, "mlp_ratio": 2,
              "upsampler": "pixelshuffledirect"}


def _lr(seed=0, h=24, w=24):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _jax_flat(noise: float = 0.05):
    """The tiny SRFormerV2's JAX params (2x), init plus noise (so every
    LayerNorm affine, bias and table moves a real value through the bridge)."""
    net = jax_build_network({**TINY, "scale": 2})
    params = net.init(jax.random.key(0), jnp.asarray(_lr()), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * noise).astype(np.float32)
            for k, v in JaxBaseModel.flatten_params(params).items()}
    return net, flat


def _jax_apply(jnet, flat, lr):
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))


def test_preset_matches_jax_param_shapes():
    """The preset's parameters, through the bridge, have the port's keys and
    shapes (JAX shapes from eval_shape: nothing is initialised): 6 layers of
    4 PSA and 3 Swin blocks at embed 240, 8 heads, window 36, squeeze 60."""
    net = jax_build_network({"type": "srformerv2", "scale": 4})
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 36, 36, 3)),
                                             train=False))["params"]
    flat = {".".join(p.key for p in path): np.empty(s.shape, np.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(flat, "SRFormerV2").items()}
    port = build_network({"type": "srformerv2", "scale": 4})
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    blocks = port.layers[0].residual_group.blocks
    assert [type(b).__name__ for b in blocks] == ["SwinBlockV2", "PSABlockV2", "PSABlockV2",
                                                  "SwinBlockV2", "PSABlockV2", "PSABlockV2",
                                                  "SwinBlockV2"]
    assert len(port.layers) == 6 and blocks[0].window_size == 12
    assert blocks[0].attn.relative_position_bias_table.shape == (23 * 23, 8)
    assert blocks[1].attn.relative_position_bias_table.shape == (35 * 35, 8)


def test_srformerv2_test_template_builds():
    """The repo's SRFormerV2 test template decodes strictly and builds in the port."""
    from trainner_redux_tpu_torch.utils.options import yaml_load

    opt, _ = yaml_load(str(REPO / "configs" / "_templates" / "test" / "SRFormerV2"
                           / "srformerv2_test.yml"))
    net = build_network({**opt.network_g, "scale": opt.scale})
    assert net.upscale == opt.scale == 4
    assert sum(p.numel() for p in net.parameters()) > 0


def test_bridge_loads_strictly_and_round_trips_through_the_jax_converter():
    from trainner_redux_tpu.utils.torch_compat import _convert_srformerv2

    jnet, flat = _jax_flat()
    sd = state_dict_from_jax(flat, "SRFormerV2")
    net = build_network({**TINY, "scale": 2})
    net.load_state_dict(sd, strict=True)
    pre = "layers.0.residual_group.blocks"
    assert f"{pre}.1.mlp.dwconv.depthwise_conv.0.weight" in sd
    assert f"{pre}.1.attn.relative_position_bias_table" in sd
    assert f"{pre}.0.attn.qkv.weight" in sd and f"{pre}.2.attn.kv.bias" in sd
    assert "conv_after_body.weight" in sd and "conv_before_upsample.0.bias" in sd
    assert "upsample.0.weight" in sd and "conv_last.bias" in sd
    back = _convert_srformerv2({k: v.numpy() for k, v in sd.items()}, jnet)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_golden_srformerv2_fixture_through_load_network(tmp_path, monkeypatch):
    """The reference-torch SRFormerV2's checkpoint (with its
    relative_position_index, aligned_relative_position_index and attn_mask
    buffers) loads strictly through SRModel.load_network and reproduces the
    reference output."""
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    data = np.load(GOLDEN / "srformerv2.npz")
    x, y = data["x"], data["y"]
    raw = {
        "name": "golden_srformerv2", "scale": 2, "num_gpu": 1, "network_g": dict(GOLDEN_NET),
        "path": {"pretrain_network_g": str(GOLDEN / "srformerv2.safetensors"),
                 "strict_load_g": True},
    }
    opt = resolve_options(decode(raw, ReduxOptions), str(tmp_path), is_train=False)
    model = build_model(opt, device="cpu")
    with torch.no_grad():
        got = model.net_g(torch.from_numpy(x)).numpy()
    assert got.shape == y.shape == (1, 3, 24, 24)
    assert np.abs(got - y).max() < 2e-4 * max(1.0, float(np.abs(y).max()))


@pytest.mark.parametrize(("branch", "jax_mode", "size"), [
    ("kernels", "interpret", (24, 24)), ("kernels", "0", (24, 24)),
    ("plain", "interpret", (24, 24)), ("plain", "0", (24, 24)),
    ("kernels", "interpret", (20, 18)),  # reflect-padded to 24x24
])
def test_srformerv2_matches_jax(branch, jax_mode, size, monkeypatch):
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", jax_mode)
    jnet, flat = _jax_flat()
    lr = _lr(2, *size)
    want = _jax_apply(jnet, flat, lr)

    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "1" if branch == "kernels" else "0")
    from trainner_redux_tpu_torch.ops import fused_block as fb

    calls = {"attn": 0, "mlp": 0}
    real_attn, real_mlp = fb._AttnBlock.apply, fb._LnMlp.apply

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fb._AttnBlock, "apply", count("attn", real_attn))
    monkeypatch.setattr(fb._LnMlp, "apply", count("mlp", real_mlp))
    net = build_network({**TINY, "scale": 2})
    net.load_state_dict(state_dict_from_jax(flat, "SRFormerV2"), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    # three Swin blocks, each a #1 and a #2 call, or none
    assert calls == ({"attn": 3, "mlp": 3} if branch == "kernels" else {"attn": 0, "mlp": 0})
    assert got.shape == want.shape == (1, 2 * size[0], 2 * size[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(("dim", "heads", "ratio", "mode", "want"), [
    (300, 10, 1.0, "train", []), (300, 10, 1.0, "eval", [300]),
    (240, 8, 2.0, "train", [240]),
])
def test_a_block_without_backward_kernels_trains_plain(dim, heads, ratio, mode, want,
                                                       monkeypatch):
    """C 300, hidden 300: #7 has no plan (286 KB for the one-pass tiles; the
    two-pass form needs hidden / 2 >= C), so in training the Swin block
    takes its plain modules, which compute the same function; at eval it
    takes the kernels. SRFormerV2's C 240, hidden 480 trains on them."""
    from trainner_redux_tpu_torch.archs.srformerv2_arch import SwinBlockV2
    from trainner_redux_tpu_torch.ops import fused_block as fb

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    calls = []
    real = fb._AttnBlock.apply

    def counted(*a):
        calls.append(a[0].shape[-1])
        return real(*a)

    monkeypatch.setattr(fb._AttnBlock, "apply", counted)
    gen = torch.Generator().manual_seed(0)
    blk = SwinBlockV2(dim, heads, 12, 0, ratio)
    blk.train(mode == "train")
    x = torch.randn(1, 12, 12, dim, generator=gen)
    with torch.no_grad():
        out = blk(x)
        assert calls == want
        monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")  # both branches give the same block
        torch.testing.assert_close(blk(x), out, atol=1e-5, rtol=1e-5)
