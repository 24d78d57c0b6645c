"""Torch port's SwinIR vs the JAX package's, on the CPU.

A tiny SwinIR (embed 24, depths [2, 2], 3 heads, window 8, 4x) is
initialised in flax; its parameters go through the port's weight bridge
`state_dict_from_jax` into the torch module with strict=True, and one LR
image of 16x24 (a shifted block layer is active) runs through both. The
port's three SwinBlock branches (fused kernels, unfused around the window
kernel, plain) are each held against the JAX output: the fused branch
against the JAX fused kernels in interpret mode, the other two against the
JAX unfused path. Tolerance 1e-4 on [0, 1]-scale outputs (fp32, four
transformer blocks, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_redux_tpu.archs.swinir_arch import SwinIR as JaxSwinIR
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu.utils.torch_compat import export_torch_state_dict
from trainner_redux_tpu_torch.archs.swinir_arch import SwinIR
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(3, 3), window_size=8)
UPSAMPLERS = {
    "pixelshuffle": dict(upsampler="pixelshuffle", resi_connection="1conv"),
    "pixelshuffledirect": dict(upsampler="pixelshuffledirect", resi_connection="1conv"),
    "nearest+conv": dict(upsampler="nearest+conv", resi_connection="3conv"),
}
BRANCHES = {
    # port env -> JAX env of the matching JAX path
    "fused": ({}, {"TRAINNER_FUSED_BLOCK": "interpret"}),
    "unfused": ({"TRAINNER_FUSED_BLOCK": "0"}, {"TRAINNER_FUSED_BLOCK": "0"}),
    "plain": ({"TRAINNER_FUSED_ATTN": "0"}, {"TRAINNER_FUSED_BLOCK": "0"}),
}


def _lr(seed=0, h=16, w=24):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)


def _jax_model(cfg, monkeypatch):
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
    net = JaxSwinIR(upscale=4, **TINY, **cfg)
    params = net.init(jax.random.key(0), jnp.asarray(_lr()), train=False)["params"]
    # non-trivial LayerNorm affines and biases, so the bridge moves real values
    rng = np.random.default_rng(1)
    flat = {
        k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.05)
        for k, v in JaxBaseModel.flatten_params(params).items()
    }
    return net, flat


def _torch_model(cfg, flat):
    net = SwinIR(upscale=4, **TINY, **cfg)
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    return net.eval()


@pytest.mark.parametrize("upsampler", list(UPSAMPLERS))
def test_state_dict_keys_match_official_export(upsampler, monkeypatch):
    cfg = UPSAMPLERS[upsampler]
    _, flat = _jax_model(cfg, monkeypatch)
    sd = state_dict_from_jax(flat)
    net = SwinIR(upscale=4, **TINY, **cfg)
    assert set(sd) == set(net.state_dict())
    if cfg["resi_connection"] == "1conv":
        # the JAX exporter writes the official torch keys for 1conv models
        exported = export_torch_state_dict(flat, "SwinIR")
        assert set(sd) == set(exported)
        for k, v in exported.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_swinir_matches_jax(branch, monkeypatch):
    cfg = UPSAMPLERS["pixelshuffle"]
    jnet, flat = _jax_model(cfg, monkeypatch)
    port_env, jax_env = BRANCHES[branch]
    for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in jax_env.items():
        monkeypatch.setenv(k, v)
    lr = _lr()
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))

    for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in port_env.items():
        monkeypatch.setenv(k, v)
    net = _torch_model(cfg, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("upsampler", ["pixelshuffledirect", "nearest+conv"])
def test_swinir_upsamplers_match_jax(upsampler, monkeypatch):
    """The other two upsamplers (and the 3conv residual) on an unaligned
    14x18 input, which the network reflect-pads to the window."""
    cfg = UPSAMPLERS[upsampler]
    jnet, flat = _jax_model(cfg, monkeypatch)
    lr = _lr(seed=2, h=14, w=18)
    params = JaxBaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(lr), train=False))
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    net = _torch_model(cfg, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 56, 72, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("update", ["in_place", "load_assign"])
def test_fused_branch_follows_weight_updates(update, monkeypatch):
    """The fused branch reads the block's current weights at every forward:
    after an in-place update, or after load_state_dict(assign=True) swaps
    the parameter tensors, it agrees with the plain branch."""
    from trainner_redux_tpu_torch.archs.swinir_arch import SwinBlock

    for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN"):
        monkeypatch.delenv(k, raising=False)
    blk = SwinBlock(24, 3, 8, shift_size=4).eval()
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((1, 16, 16, 24)).astype(np.float32)
    )
    with torch.no_grad():
        before = blk(x)
        if update == "in_place":
            blk.attn.qkv.weight.mul_(1.5)
            blk.mlp.fc1.weight.mul_(0.5)
        else:
            sd = {k: v * 1.5 for k, v in blk.state_dict().items()}
            blk.load_state_dict(sd, assign=True)
        fused = blk(x)
        monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
        plain = blk(x)
    assert (fused - before).abs().max() > 1e-3
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-5, rtol=0)


def test_patch_norm_eps_follows_jax():
    """patch_embed.norm uses flax's default eps 1e-6 (upstream SwinIR: 1e-5)."""
    net = SwinIR(upscale=4, **TINY)
    assert net.patch_embed.norm.eps == 1e-6
    assert net.norm.eps == 1e-5
    assert net.layers[0].residual_group.blocks[0].norm1.eps == 1e-5


def test_buffers_are_not_persistent():
    net = SwinIR(upscale=4, **TINY)
    keys = set(net.state_dict())
    assert not any(k.endswith(("relative_position_index", "mask_kinds", "mean")) for k in keys)
    assert "layers.0.residual_group.blocks.1.attn.qkv.weight" in keys
