"""The weight bridge: checkpoints of either framework into the port's
modules, which use the official torch key names.

Port of the SwinIR and HAT parts of the JAX package's utils/torch_compat.py:

- `canonicalize_state_dict`: unwrap `params_ema` / `params` / `state_dict`
  nesting and strip DDP's `module.` prefix (upstream's key canonicalization);
- `load_torch_state_dict`: a `.pth` / `.pt` pickle or a torch-layout
  safetensors file as numpy arrays;
- `state_dict_from_jax`: the JAX package's flattened parameters
  (`.`-joined flax keys, as `BaseModel.flatten_params` gives them) as the
  port's state dict. For SwinIR it is the JAX `_export_swinir` mapping,
  extended to the 3conv residual connection and every upsampler; for HAT
  the JAX `_export_hat` mapping.

Buffers that upstream checkpoints carry and the port recomputes
(`relative_position_index` and HAT's `relative_position_index_SA` /
`_OCA`, `attn_mask`, `mean`) are dropped on load.
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
    """Drop the buffers upstream SwinIR and HAT checkpoints carry and the
    port recomputes."""
    return {
        k: v for k, v in sd.items()
        if not k.endswith(("relative_position_index", "relative_position_index_SA",
                           "relative_position_index_OCA", "attn_mask"))
        and not k.startswith(("absolute_pos_embed", "mean"))
    }


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


_KEY_MAPS = {"swinir": _swinir_key, "hat": _hat_key}


def state_dict_from_jax(flat: dict[str, np.ndarray], arch: str = "SwinIR") -> dict:
    """The JAX package's flattened params -> the port's state dict (tensors)."""
    import torch

    key_map = _KEY_MAPS.get(arch.lower())
    if key_map is None:
        raise NotImplementedError(f"no weight bridge for arch '{arch}' yet")
    out = {}
    for k, v in flat.items():
        key, arr = key_map(k, np.asarray(v))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return out
