"""The weight bridge: checkpoints of either framework into the port's
modules, which use the official torch key names.

Port of the SwinIR, HAT, DAT, Swin2SR, SRFormerV2, SRFormer, ATD, DRCT, DUnet,
SPAN, SPANF, SpanPlus, SpanC, SRVGGNetCompact and RRDBNet parts of the JAX
package's utils/torch_compat.py:

- `canonicalize_state_dict`: unwrap `params_ema` / `params` / `state_dict`
  nesting and strip DDP's `module.` prefix (upstream's key canonicalization);
- `load_torch_state_dict`: a `.pth` / `.pt` pickle or a torch-layout
  safetensors file as numpy arrays;
- `state_dict_from_jax`: the JAX package's flattened parameters
  (`.`-joined flax keys, as `BaseModel.flatten_params` gives them) as the
  port's state dict. For SwinIR it is the JAX `_export_swinir` mapping,
  extended to the 3conv residual connection and every upsampler; for HAT
  the JAX `_export_hat` mapping; for SRFormer the JAX `_export_srformer`
  mapping; for ATD the JAX `_export_atd` layout with the window and
  category attentions' qkv Linears apart; for DAT, Swin2SR, SRFormerV2 and
  DRCT the inverse of the JAX `_convert_dat`, `_convert_swin2sr`,
  `_convert_srformerv2` and `_convert_drct` (the JAX package has no
  exporter for them); for
  DUnet the inverse of the JAX `_convert_dunet`, the `spectral`
  collection's u and v included (as `__spectral__.<module>.u` / `.v`); for
  the conv families the inverse of `_convert_span`, `_convert_spanf`,
  `_convert_spanplus`, `_convert_spanc`, `_convert_srvgg` and
  `_convert_rrdbnet`;
- `drop_folded_copies`: the folded convolutions upstream SPAN, SPANPlus
  and SpanC checkpoints also save (each Conv3XC's `eval_conv`, each
  RepConv's `conv_3x3_rep`), which the port recomputes from the parameters
  and the JAX converters ignore, dropped where the network has no such key
  (SPANF's weights are its `eval_conv`s);
- `canonical_spectral_keys`: either torch spectral-norm API's keys (the
  legacy `weight_orig` / `weight_u` / `weight_v`, or the parametrization's)
  as the port's `parametrizations.weight.original` / `.0._u` / `.0._v`;
- `canonical_atd_keys`: an upstream ATD checkpoint (one shared `wqkv`, the
  `residual_group` container, `td` or `token_dict`) in the port's keys, as
  the JAX `_convert_atd` reads it; `norm3` is refused;
- `pack_qkv_bias`: upstream Swin2SR's `attn.q_bias` / `attn.v_bias` as the
  port's one `attn.qkv.bias` = [q, 0, v], as the JAX `_convert_swin2sr`
  packs them.

Buffers that upstream checkpoints carry and the port recomputes
(`relative_position_index`, HAT's `relative_position_index_SA` / `_OCA`,
`attn_mask`, DAT's `rpe_biases`, `attn.attn_mask_*` and the BatchNorms'
`num_batches_tracked`, Swin2SR's `relative_coords_table`, SRFormerV2's
`aligned_relative_position_index`, `mean`) are dropped on load.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np


def conv_w_inv(w: np.ndarray) -> np.ndarray:
    """Flax HWIO -> torch OIHW."""
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def linear_w(w: np.ndarray) -> np.ndarray:
    """Flax (in, out) <-> torch (out, in)."""
    return np.ascontiguousarray(w.T)


def canonicalize_state_dict(sd: dict[str, Any]) -> dict[str, np.ndarray]:
    """Unwrap nested param keys and strip DDP prefixes."""
    for key in ("params_ema", "params", "state_dict", "model_state_dict", "model"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.startswith(("initted", "step", "ema_model.", "online_model.")):
            # ema_pytorch bookkeeping keys
            k = k.removeprefix("ema_model.").removeprefix("online_model.")
            if k in ("initted", "step"):
                continue
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a .pth/.pt pickle or a torch-layout .safetensors file."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return canonicalize_state_dict(load_file(path))
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict):
        raise ValueError(f"{path} does not hold a state dict")
    return canonicalize_state_dict(raw)


def drop_recomputed_buffers(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Drop the buffers upstream SwinIR, HAT, DAT, Swin2SR and SRFormerV2
    checkpoints carry and the port recomputes."""
    return {
        k: v for k, v in sd.items()
        if not k.endswith(("relative_position_index", "relative_position_index_SA",
                           "relative_position_index_OCA", "attn_mask", "rpe_biases",
                           "num_batches_tracked", "relative_coords_table"))
        and not re.fullmatch(r".*\.attn\.attn_mask_\d+", k)
        and not k.startswith(("absolute_pos_embed", "mean"))
    }


def pack_qkv_bias(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Each upstream SwinV2 `<attn>.q_bias` / `<attn>.v_bias` pair as
    `<attn>.qkv.bias` = [q, 0, v] (the k bias is fixed at 0 upstream); a
    state dict without such pairs comes back as it is."""
    out = {k: v for k, v in sd.items() if not k.endswith((".q_bias", ".v_bias"))}
    for k, q in sd.items():
        if k.endswith(".q_bias"):
            pre = k.removesuffix(".q_bias")
            out[f"{pre}.qkv.bias"] = np.concatenate([q, np.zeros_like(q), sd[f"{pre}.v_bias"]])
    return out


def _weight_or_bias(kind: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias"}[kind]


def _swinir_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SwinIR key -> (torch key, array in torch layout)."""
    m = re.fullmatch(r"layers_(\d+)\.blocks_(\d+)\.(.+)\.(kernel|scale|bias)", k)
    if m:
        i, j, inner, kind = m.groups()
        inner = inner.replace("mlp_fc", "mlp.fc")
        key = f"layers.{i}.residual_group.blocks.{j}.{inner}.{_weight_or_bias(kind)}"
        return key, linear_w(v) if kind == "kernel" else v
    m = re.fullmatch(r"layers_(\d+)\.blocks_(\d+)\.attn\.relative_position_bias_table", k)
    if m:
        i, j = m.groups()
        return f"layers.{i}.residual_group.blocks.{j}.attn.relative_position_bias_table", v
    m = re.fullmatch(r"(patch_norm|norm)\.(scale|bias)", k)
    if m:
        name = "patch_embed.norm" if m.group(1) == "patch_norm" else "norm"
        return f"{name}.{_weight_or_bias(m.group(2))}", v
    m = re.fullmatch(r"(.+)\.conv\.(kernel|bias)", k)
    if not m:
        raise KeyError(f"no torch counterpart for SwinIR key '{k}'")
    module, kind = m.groups()
    arr = conv_w_inv(v) if kind == "kernel" else v
    for pattern, repl in (
        (r"layers_(\d+)\.conv", r"layers.\1.conv"),
        (r"layers_(\d+)\.conv_(\d+)", lambda g: f"layers.{g[1]}.conv.{2 * int(g[2])}"),
        (r"conv_after_body_(\d+)", lambda g: f"conv_after_body.{2 * int(g[1])}"),
        (r"conv_before_upsample", "conv_before_upsample.0"),
        (r"upsample_(\d+)", lambda g: f"upsample.{2 * int(g[1])}"),
        (r"upsample_direct", "upsample.0"),
        (r"conv_first|conv_after_body|conv_last|conv_up\d+|conv_hr", r"\g<0>"),
    ):
        if re.fullmatch(pattern, module):
            return f"{re.sub(pattern, repl, module)}.{_weight_or_bias(kind)}", arr
    raise KeyError(f"no torch counterpart for SwinIR key '{k}'")


# HAT's CAB convs: flax name -> upstream Sequential index
_CAB = {"conv0": "cab.0", "conv1": "cab.2", "att0": "cab.3.attention.1",
        "att1": "cab.3.attention.3"}


def _hat_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax HAT key -> (torch key, array in torch layout)."""
    m = re.fullmatch(r"layers_(\d+)\.blocks_(\d+)\.conv_block\.(\w+)\.conv\.(kernel|bias)", k)
    if m:
        i, j, part, kind = m.groups()
        key = f"layers.{i}.residual_group.blocks.{j}.conv_block.{_CAB[part]}"
        return f"{key}.{_weight_or_bias(kind)}", conv_w_inv(v) if kind == "kernel" else v
    m = re.fullmatch(r"layers_(\d+)\.(?:blocks_(\d+)|overlap_attn)\.(.+)", k)
    if m:
        i, j, rest = m.groups()
        owner = f"layers.{i}.residual_group." + (f"blocks.{j}" if j else "overlap_attn")
        if rest.endswith("relative_position_bias_table"):
            return f"{owner}.{rest}", v
        inner, kind = rest.replace("mlp_fc", "mlp.fc").rsplit(".", 1)
        return f"{owner}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
    # the rest (patch and final norms, the convs) is named as in SwinIR
    return _swinir_key(k, v)


# DAT's flax module names -> upstream's Sequential members
_DAT_CONVS = {"dwconv": "dwconv.0", "ci_0": "channel_interaction.1",
              "ci_1": "channel_interaction.4", "si_0": "spatial_interaction.0",
              "si_1": "spatial_interaction.3"}
_DAT_BNS = {"dw_bn": "dwconv.1", "ci_bn": "channel_interaction.2",
            "si_bn": "spatial_interaction.1"}
_BN_PARAMS = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _dat_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax DAT key -> (torch key, array in torch layout): the inverse of
    the JAX `_convert_dat`."""
    m = re.fullmatch(r"layers_(\d+)_blocks_(\d+)\.(.+)", k)
    if m:
        i, j, rest = m.groups()
        pre = f"layers.{i}.blocks.{j}"
        m = re.fullmatch(r"attn\.(\w+)\.(scale|bias|mean|var)", rest)
        if m and m.group(1) in _DAT_BNS:
            return f"{pre}.attn.{_DAT_BNS[m.group(1)]}.{_BN_PARAMS[m.group(2)]}", v
        m = re.fullmatch(r"(attn|ffn)\.(\w+)\.conv\.(kernel|bias)", rest)
        if m:
            owner, name, kind = m.groups()
            inner = _DAT_CONVS.get(name, "sg.conv" if name == "sg_conv" else None)
            if inner is None:
                raise KeyError(f"no torch counterpart for DAT key '{k}'")
            return (f"{pre}.{owner}.{inner}.{_weight_or_bias(kind)}",
                    conv_w_inv(v) if kind == "kernel" else v)
        m = re.fullmatch(r"attn\.attns_(\d+)\.pos\.(\w+)\.(kernel|scale|bias)", rest)
        if m:
            b, name, kind = m.groups()
            ppre = f"{pre}.attn.attns.{b}.pos"
            if name.startswith("norm"):
                return f"{ppre}.pos{name[4:]}.0.{_weight_or_bias(kind)}", v
            inner = "pos_proj" if name == "pos_proj" else f"{name}.2"
            return f"{ppre}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
        if rest == "attn.temperature":
            return f"{pre}.{rest}", v
        inner, kind = rest.replace("sg_norm", "sg.norm").rsplit(".", 1)
        if inner not in ("norm1", "norm2", "ffn.sg.norm", "attn.qkv", "attn.proj", "ffn.fc1",
                         "ffn.fc2"):
            raise KeyError(f"no torch counterpart for DAT key '{k}'")
        return f"{pre}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
    m = re.fullmatch(r"(before_RG|norm)\.(scale|bias)", k)
    if m:
        name = "before_RG.1" if m.group(1) == "before_RG" else "norm"
        return f"{name}.{_weight_or_bias(m.group(2))}", v
    # the convs are named as in SwinIR, but for DAT's own layers_i_conv and
    # up_direct (the JAX `_convert_dat` writes `upsample_direct` for it)
    k = re.sub(r"^layers_(\d+)_conv\.", r"layers_\1.conv.", k)
    return _swinir_key(re.sub(r"^up_direct\.", "upsample_direct.", k), v)


def _dat_zero_pos_layers(out: dict[str, np.ndarray]) -> None:
    """Add the 0-element position-MLP layers upstream DAT keeps at tiny
    widths (pos_dim 0), which the JAX package's bias-only form drops."""
    for key in [k for k in out if k.endswith(".pos.pos3.2.weight")]:
        if out[key].shape[1] != 0:
            continue
        pre = key.removesuffix("pos3.2.weight")
        empty = np.zeros((0,), np.float32)
        out[f"{pre}pos_proj.weight"] = np.zeros((0, 2), np.float32)
        out[f"{pre}pos_proj.bias"] = empty
        for p in ("pos1", "pos2", "pos3"):
            out[f"{pre}{p}.0.weight"] = out[f"{pre}{p}.0.bias"] = empty
        for p in ("pos1", "pos2"):
            out[f"{pre}{p}.2.weight"] = np.zeros((0, 0), np.float32)
            out[f"{pre}{p}.2.bias"] = empty


# Swin2SR's attention parts: flax name -> upstream module
_SWIN2SR_ATTN = {"qkv": "qkv", "proj": "proj", "cpb_fc1": "cpb_mlp.0", "cpb_fc2": "cpb_mlp.2"}


def _swin2sr_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax Swin2SR key -> (torch key, array in torch layout): the
    inverse of the JAX `_convert_swin2sr`."""
    m = re.fullmatch(r"layers_(\d+)_blocks_(\d+)\.(.+)", k)
    if m:
        i, j, rest = m.groups()
        pre = f"layers.{i}.residual_group.blocks.{j}"
        if rest == "attn.logit_scale":
            return f"{pre}.{rest}", v
        m = re.fullmatch(r"(?:attn\.(\w+)|(norm[12]|fc[12]))\.(kernel|scale|bias)", rest)
        if m and (m.group(2) or m.group(1) in _SWIN2SR_ATTN):
            attn, own, kind = m.groups()
            inner = f"attn.{_SWIN2SR_ATTN[attn]}" if attn else own.replace("fc", "mlp.fc")
            return f"{pre}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
        raise KeyError(f"no torch counterpart for Swin2SR key '{k}'")
    # the norms and convs are named as in SwinIR, but for the groups' layers_i_conv
    return _swinir_key(re.sub(r"^layers_(\d+)_conv\.", r"layers_\1.conv.", k), v)


# SRFormerV2's block parts: flax name -> upstream module (the rest, norm1,
# norm2 and PSA's attn.q / attn.kv / attn.proj, keep their names)
_SRFORMERV2_PARTS = {"qkv": "attn.qkv", "proj": "attn.proj", "mlp_fc1": "mlp.fc1",
                     "mlp_fc2": "mlp.fc2", "norm1": "norm1", "norm2": "norm2",
                     "attn.q": "attn.q", "attn.kv": "attn.kv", "attn.proj": "attn.proj"}


def _srformerv2_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SRFormerV2 key -> (torch key, array in torch layout): the
    inverse of the JAX `_convert_srformerv2`, whose Swin blocks keep their
    table, qkv and proj at block level and whose PSA blocks keep the table
    inside `attn`."""
    m = re.fullmatch(r"layers_(\d+)_b(\d+)\.(.+)", k)
    if m:
        i, j, rest = m.groups()
        pre = f"layers.{i}.residual_group.blocks.{j}"
        if rest in ("relative_position_bias_table", "attn.relative_position_bias_table"):
            return f"{pre}.attn.relative_position_bias_table", v
        m = re.fullmatch(r"mlp_dw\.conv\.(kernel|bias)", rest)
        if m:
            kind = m.group(1)
            return (f"{pre}.mlp.dwconv.depthwise_conv.0.{_weight_or_bias(kind)}",
                    conv_w_inv(v) if kind == "kernel" else v)
        inner, kind = rest.rsplit(".", 1)
        if inner not in _SRFORMERV2_PARTS:
            raise KeyError(f"no torch counterpart for SRFormerV2 key '{k}'")
        return (f"{pre}.{_SRFORMERV2_PARTS[inner]}.{_weight_or_bias(kind)}",
                linear_w(v) if kind == "kernel" else v)
    # the norms and convs are named as in SwinIR, but for the layers'
    # layers_i_conv and pixelshuffledirect's `upsample`
    k = re.sub(r"^layers_(\d+)_conv\.", r"layers_\1.conv.", k)
    return _swinir_key(re.sub(r"^upsample\.conv\.", "upsample_direct.conv.", k), v)


def _srformer_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SRFormer key -> (torch key, array in torch layout): the JAX
    `_export_srformer` mapping, through SwinIR's (the blocks' `fc1` / `fc2`
    are upstream's `mlp.fc1` / `mlp.fc2`)."""
    k = re.sub(r"^layers_(\d+)_blocks_(\d+)\.fc([12])\.", r"layers_\1.blocks_\2.mlp_fc\3.", k)
    k = re.sub(r"^layers_(\d+)_(blocks_\d+|conv)\.", r"layers_\1.\2.", k)
    return _swinir_key(re.sub(r"^up_direct\.conv\.", "upsample_direct.conv.", k), v)


def _atd_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax ATD key -> (torch key, array in torch layout): the JAX
    `_export_atd` layout with `attn_win.qkv` and `attn_aca.qkv` apart (the
    JAX tree keeps two, where upstream shares one `wqkv`)."""
    if m := re.fullmatch(r"groups_(\d+)\.token_dict", k):
        return f"layers.{m[1]}.td", v
    if m := re.fullmatch(r"groups_(\d+)\.layers_(\d+)\.(.+)", k):
        pre, rest = f"layers.{m[1]}.layers.{m[2]}", m[3]
        if rest in ("attn_win.relative_position_bias_table", "attn_atd.scale", "sigma"):
            return f"{pre}.{rest}", v
        if m2 := re.fullmatch(r"convffn\.dwconv\.conv\.(kernel|bias)", rest):
            return (f"{pre}.convffn.dwconv.{_weight_or_bias(m2[1])}",
                    conv_w_inv(v) if m2[1] == "kernel" else v)
        inner, kind = rest.rsplit(".", 1)
        if inner not in ("norm1", "norm2", "attn_win.qkv", "attn_win.proj", "attn_aca.qkv",
                         "attn_aca.proj", "attn_atd.wq", "attn_atd.wk", "attn_atd.wv",
                         "convffn.fc1", "convffn.fc2"):
            raise KeyError(f"no torch counterpart for ATD key '{k}'")
        return f"{pre}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
    k = re.sub(r"^groups_(\d+)\.conv\.", r"layers_\1.conv.", k)
    return _swinir_key(re.sub(r"^up_direct\.conv\.", "upsample_direct.conv.", k), v)


def _drct_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax DRCT key -> (torch key, array in torch layout): the inverse
    of the JAX `_convert_drct` (`layers_i.swin_k.*` as upstream's
    `layers.i.swinK.*`, `layers_i.adjust_k` as `layers.i.adjustK`), the
    norms and the other convolutions named as in SwinIR."""
    if m := re.fullmatch(r"layers_(\d+)\.swin_(\d)\.(.+)", k):
        pre, rest = f"layers.{m[1]}.swin{m[2]}", m[3]
        if rest == "attn.relative_position_bias_table":
            return f"{pre}.{rest}", v
        inner, kind = rest.rsplit(".", 1)
        if inner not in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp_fc1", "mlp_fc2"):
            raise KeyError(f"no torch counterpart for DRCT key '{k}'")
        inner = inner.replace("mlp_fc", "mlp.fc")
        return f"{pre}.{inner}.{_weight_or_bias(kind)}", linear_w(v) if kind == "kernel" else v
    if m := re.fullmatch(r"layers_(\d+)\.adjust_(\d)\.conv\.(kernel|bias)", k):
        return (f"layers.{m[1]}.adjust{m[2]}.{_weight_or_bias(m[3])}",
                conv_w_inv(v) if m[3] == "kernel" else v)
    return _swinir_key(k, v)


def canonical_atd_keys(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """An upstream ATD state dict in the port's keys, as the JAX
    `_convert_atd` reads it: the shared `wqkv` copied into `attn_win.qkv`
    and `attn_aca.qkv`, the `layers.{g}.residual_group.` container as
    `layers.{g}.`, the dictionary `td` or `token_dict` as `td`, the ConvFFN's
    `dwconv.depthwise_conv.0` as `dwconv`, `attn_atd.scale` as its first
    entry and `sigma` as a column. A checkpoint with `norm3` raises, as the
    JAX converter does."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if ".norm3." in k:
            raise NotImplementedError(
                f"ATD checkpoint carries norm3 ({k}): a separate norm for the dictionary "
                "attention, which the ATD layer (as the JAX package's) does not have; it "
                "normalizes all three branches with norm1")
        k = re.sub(r"^layers\.(\d+)\.residual_group\.", r"layers.\1.", k)
        k = re.sub(r"^(layers\.\d+)\.token_dict$", r"\1.td", k)
        k = k.replace(".convffn.dwconv.depthwise_conv.0.", ".convffn.dwconv.")
        if m := re.fullmatch(r"(layers\.\d+\.layers\.\d+)\.wqkv\.(weight|bias)", k):
            out[f"{m[1]}.attn_win.qkv.{m[2]}"] = v
            out[f"{m[1]}.attn_aca.qkv.{m[2]}"] = v.copy()
            continue
        if k.endswith(".attn_atd.scale"):
            v = v.reshape(-1)[:1]
        elif k.endswith(".sigma"):
            v = v.reshape(-1, 1)
        out[k] = v
    return out


def canonical_spectral_keys(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Spectral-norm keys of either torch API as the port's parametrization
    keys; other keys come back as they are."""
    renames = ((".weight_orig", ".parametrizations.weight.original"),
               (".weight_u", ".parametrizations.weight.0._u"),
               (".weight_v", ".parametrizations.weight.0._v"),
               (".parametrizations.weight._u", ".parametrizations.weight.0._u"),
               (".parametrizations.weight._v", ".parametrizations.weight.0._v"))
    out = {}
    for k, v in sd.items():
        for old, new in renames:
            if k.endswith(old):
                k = k.removesuffix(old) + new
                break
        out[k] = v
    return out


# DUnet's flax modules -> (upstream module, spectrally normalised)
_DUNET = {"in_to_dim.conv": ("in_to_dim", False), "end_conv0": ("end_conv.0", True),
          "end_conv1": ("end_conv.2", True), "end_conv2.conv": ("end_conv.4", False),
          **{f"e_x{i}.conv": (f"e_x{i}.0", True) for i in (1, 2, 3)},
          **{f"up{i}.conv": (f"up{i}.1", True) for i in (1, 2, 3)},
          **{f"up{i}.dysample.{c}.conv": (f"up{i}.0.{c}", False)
             for i in (1, 2, 3) for c in ("offset", "scope")}}


def _dunet_state_dict(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The JAX DUnet's flattened params (and `__spectral__.<module>.u` /
    `.v`, the JAX `_convert_dunet`'s form of its spectral collection) as the
    port's state dict: the inverse of `_convert_dunet`. v is indexed over
    flax's (kh, kw, in) flattening there and over torch's (in, kh, kw)
    here. Upstream's `init_pos` buffers are added."""
    from trainner_redux_tpu_torch.archs.arch_util import dysample_init_pos

    out = {}
    for k, v in flat.items():
        spectral = k.startswith(("__spectral__.", "spectral."))
        module, kind = k.split(".", 1)[1].rsplit(".", 1) if spectral else k.rsplit(".", 1)
        if module not in _DUNET:
            raise KeyError(f"no torch counterpart for DUnet key '{k}'")
        tpre, sn = _DUNET[module]
        if spectral and kind == "u":
            out[f"{tpre}.parametrizations.weight.0._u"] = v
        elif spectral and kind == "v":
            kh, kw, cin, _ = flat[f"{module}.kernel"].shape
            out[f"{tpre}.parametrizations.weight.0._v"] = np.ascontiguousarray(
                v.reshape(kh, kw, cin).transpose(2, 0, 1).reshape(-1))
        elif kind == "kernel":
            out[f"{tpre}.parametrizations.weight.original" if sn else f"{tpre}.weight"] = \
                conv_w_inv(v)
        elif kind == "bias":
            out[f"{tpre}.bias"] = v
        else:
            raise KeyError(f"no torch counterpart for DUnet key '{k}'")
    for i in (1, 2, 3):
        out[f"up{i}.0.init_pos"] = dysample_init_pos(2, 4).numpy()
    return out


def drop_folded_copies(sd: dict[str, np.ndarray], keep) -> dict[str, np.ndarray]:
    """`sd` without the `.eval_conv.` / `.conv_3x3_rep.` weights and biases
    that are not among the keys `keep` (the network's own)."""
    return {k: v for k, v in sd.items()
            if k in keep or not re.search(r"\.(eval_conv|conv_3x3_rep)\.(weight|bias)$", k)}


_CONV3XC = {"conv0_kernel": "conv.0.weight", "conv0_bias": "conv.0.bias",
            "conv1_kernel": "conv.1.weight", "conv1_bias": "conv.1.bias",
            "conv2_kernel": "conv.2.weight", "conv2_bias": "conv.2.bias",
            "sk_kernel": "sk.weight", "sk_bias": "sk.bias"}


def _conv3xc_or_conv(k: str, v: np.ndarray, renames=()) -> tuple[str, np.ndarray]:
    """A flax Conv3XC parameter (`<pre>.conv0_kernel`, ...) or plain Conv2d
    (`<pre>.conv.kernel` / `.bias`) -> (torch key, array), `<pre>` passed
    through `renames` ((pattern, replacement) pairs, applied in turn)."""
    pre, leaf = k.rsplit(".", 1)
    if leaf in _CONV3XC:
        tail = _CONV3XC[leaf]
    elif pre.endswith(".conv") and leaf in ("kernel", "bias"):
        pre, tail = pre.removesuffix(".conv"), _weight_or_bias(leaf)
    else:
        raise KeyError(f"no torch counterpart for key '{k}'")
    for pattern, repl in renames:
        pre = re.sub(pattern, repl, pre)
    return f"{pre}.{tail}", conv_w_inv(v) if v.ndim == 4 else v


def _span_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SPAN key -> (torch key, array): the inverse of `_convert_span`."""
    return _conv3xc_or_conv(k, v, ((r"^upsampler_conv$", "upsampler.0"),))


def _spanf_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SPANF key: the inverse of `_convert_spanf`, whose block and
    conv_2 weights are upstream's `eval_conv`s."""
    if k == "conv_near_kernel":
        return "conv_near.weight", conv_w_inv(v)
    return _conv3xc_or_conv(k, v, ((r"^(block_\d\.c\d_r|conv_2)$", r"\1.eval_conv"),))


def _spanplus_key(k: str, v: np.ndarray, conv_upsampler: bool = False) -> tuple[str, np.ndarray]:
    """One flax SpanPlus key: the inverse of `_convert_spanplus`. `up_conv`
    is the pixel-shuffle upsampler's convolution (`upsampler.0`), or with
    `conv_upsampler` the scale-1 convolution (`upsampler`)."""
    return _conv3xc_or_conv(k, v, (
        (r"^feats_(\d+)", r"feats.\1"), (r"\.block_n_(\d+)", r".block_n.\1"),
        (r"^up_conv$", "upsampler" if conv_upsampler else "upsampler.0"),
        (r"^dysample\.", "upsampler.")))


def _spanc_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SpanC key: the inverse of `_convert_spanc` (RepConv's raw
    SeqConv3x3 kernels, IGConv's embeddings and 1x1 query MLP)."""
    m = re.fullmatch(r"(.+)\.(alpha|conv1\.[kb][01])", k)
    if m:
        return k, conv_w_inv(v) if v.ndim == 4 else v
    m = re.fullmatch(r"upsampler\.(freq|amplitude|phase_w|phase_b)", k)
    if m:
        name = m.group(1)
        if name == "phase_w":
            return "upsampler.phase.weight", np.ascontiguousarray(v.T.reshape(-1, 1, 1, 1))
        if name == "phase_b":
            return "upsampler.phase.bias", v
        return f"upsampler.{name}", v.reshape(*v.shape, 1, 1)
    m = re.fullmatch(r"upsampler\.qk_(\d+|out)\.(kernel|bias)", k)
    if m:
        # qk_out's index is set by `state_dict_from_jax` (`_last_index`)
        idx = m.group(1)
        key = f"upsampler.query_kernel.{'@' if idx == 'out' else 2 * int(idx)}"
        kind = m.group(2)
        return (f"{key}.{_weight_or_bias(kind)}",
                linear_w(v)[:, :, None, None] if kind == "kernel" else v)
    return _conv3xc_or_conv(k, v)


def _srvgg_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax SRVGGNetCompact key: the inverse of `_convert_srvgg`
    (body_last's index is set by `state_dict_from_jax`)."""
    m = re.fullmatch(r"act_(\d+)\.weight", k)
    if m:
        return f"body.{2 * int(m.group(1)) + 1}.weight", v
    m = re.fullmatch(r"body_(\d+|last)\.conv\.(kernel|bias)", k)
    if not m:
        raise KeyError(f"no torch counterpart for SRVGGNetCompact key '{k}'")
    idx = "@" if m.group(1) == "last" else 2 * int(m.group(1))
    kind = m.group(2)
    return f"body.{idx}.{_weight_or_bias(kind)}", conv_w_inv(v) if kind == "kernel" else v


def _rrdbnet_key(k: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax RRDBNet key: the inverse of `_convert_rrdbnet`."""
    return _conv3xc_or_conv(k, v, ((r"^body_(\d+)", r"body.\1"),))


def _last_index(out: dict[str, np.ndarray], prefix: str, step: int = 2) -> dict:
    """Replace the `@` placeholder index after `prefix` by the index of the
    list's last convolution: `step` times the number of convolutions before
    it, which sit at the multiples of `step` (the activations between)."""
    idx = {int(m.group(1)) for k in out if (m := re.match(rf"{re.escape(prefix)}\.(\d+)\.", k))}
    last = str(step * sum(1 for i in idx if i % step == 0))
    return {k.replace(f"{prefix}.@.", f"{prefix}.{last}."): v for k, v in out.items()}


_KEY_MAPS = {"swinir": _swinir_key, "hat": _hat_key, "dat": _dat_key, "swin2sr": _swin2sr_key,
             "srformerv2": _srformerv2_key, "srformer": _srformer_key, "atd": _atd_key,
             "drct": _drct_key,
             "span": _span_key, "spanf": _spanf_key,
             "spanplus": _spanplus_key, "spanc": _spanc_key, "srvggnetcompact": _srvgg_key,
             "rrdbnet": _rrdbnet_key}


def state_dict_from_jax(flat: dict[str, np.ndarray], arch: str = "SwinIR",
                        keys=None) -> dict:
    """The JAX package's flattened params -> the port's state dict
    (tensors). `keys`, the network's own state-dict keys where known,
    tells SpanPlus's scale-1 convolution upsampler from the pixel-shuffle
    one. Buffers (DUnet's anchors aside) are the network's to fill in."""
    import torch

    if arch.lower() == "dunet":
        return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
                for k, v in _dunet_state_dict(flat).items()}
    key_map = _KEY_MAPS.get(arch.lower())
    if key_map is None:
        raise NotImplementedError(f"no weight bridge for arch '{arch}' yet")
    if key_map is _spanplus_key and keys is not None and "upsampler.weight" in keys:
        out = dict(_spanplus_key(k, np.asarray(v), True) for k, v in flat.items())
    else:
        out = dict(key_map(k, np.asarray(v)) for k, v in flat.items())
    if key_map is _dat_key:
        _dat_zero_pos_layers(out)
    if key_map is _srvgg_key:
        out = _last_index(out, "body")
    if key_map is _spanc_key:
        out = _last_index(out, "upsampler.query_kernel")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}
