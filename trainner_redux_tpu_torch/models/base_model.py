"""BaseModel: device, weight flattening and saving, training-state files,
best-metric bookkeeping, validation dispatch.

Port of the JAX package's models/base_model.py. The JAX model places a
parameter pytree on a device mesh; here the network is an `nn.Module` on one
explicit `torch.device`. Network checkpoints are torch-layout safetensors
(which the JAX package's `load_network` reads through its torch converter);
the training state is a `torch.save` file `training_states/<iter>.state`
with the JAX package's `<iter>.state.meta.json` sidecar, so the resume scan
of both packages finds it.
"""

from __future__ import annotations

import json
import os
from os import path as osp
from typing import Any

import numpy as np
import torch

from trainner_redux_tpu_torch.utils.device import resolve_device
from trainner_redux_tpu_torch.utils.dist_util import master_only
from trainner_redux_tpu_torch.utils.logger import get_root_logger
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions


class BaseModel:
    def __init__(self, opt: ReduxOptions, device: str | torch.device | None = None) -> None:
        self.opt = opt
        self.is_train = bool(opt.is_train)
        self.logger = get_root_logger()
        self.device = resolve_device(device)
        # the JAX package's dtype policy (models/base_model.py:43-51): bf16
        # compute for `compute_dtype: bfloat16`, its default, and for the
        # reference's `use_amp`; the parameters stay fp32
        self.compute_dtype = (torch.bfloat16 if opt.compute_dtype == "bfloat16" or opt.use_amp
                              else torch.float32)
        self.best_metric_results: dict[str, Any] = {}

    @staticmethod
    def param_count(module: torch.nn.Module) -> int:
        return sum(p.numel() for p in module.parameters())

    @staticmethod
    def flatten_params(module: torch.nn.Module) -> dict[str, np.ndarray]:
        """The module's state dict as '.'-keyed contiguous numpy arrays."""
        return {
            k: np.ascontiguousarray(v.detach().cpu().numpy())
            for k, v in module.state_dict().items()
        }

    # --------------------------- checkpointing -----------------------------

    @master_only
    def save_network_safetensors(self, module: torch.nn.Module, save_path: str,
                                 metadata: dict[str, str] | None = None) -> None:
        """Save a module's state dict as torch-layout safetensors with string
        metadata in the header; retried twice on an OSError, as the JAX
        package does."""
        from safetensors.numpy import save_file

        os.makedirs(osp.dirname(save_path), exist_ok=True)
        flat = self.flatten_params(module)
        for attempt in range(3):
            try:
                save_file(flat, save_path, metadata=metadata or {})
                return
            except OSError as e:
                if attempt == 2:
                    raise
                self.logger.warning(f"save retry {attempt + 1} after: {e}")

    @master_only
    def save_training_state(self, state: dict[str, Any], epoch: int, current_iter: int) -> None:
        """`state` to training_states/<iter>.state, and the epoch and iteration
        to its .meta.json sidecar."""
        path = osp.join(osp.abspath(self.opt.path.training_states), f"{current_iter}.state")
        torch.save(state, path)
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, "iter": current_iter}, f)

    def load_training_state(self, path: str) -> tuple[dict[str, Any], dict[str, int]]:
        """(state, meta) written by save_training_state; tensors on the CPU."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        meta = {"epoch": 0, "iter": 0}
        if osp.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        return state, meta

    # ------------------------------ metrics --------------------------------

    def _init_best_metric_results(self, dataset_name: str, metric_opts: dict) -> None:
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in metric_opts.items():
            better = content.get("better", "higher")
            init_val = float("-inf") if better == "higher" else float("inf")
            record[metric] = {"better": better, "val": init_val, "iter": -1}
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(
        self, dataset_name: str, metric: str, val: float, current_iter: int
    ) -> None:
        rec = self.best_metric_results[dataset_name][metric]
        if (rec["better"] == "higher" and val >= rec["val"]) or (
            rec["better"] == "lower" and val <= rec["val"]
        ):
            rec["val"] = val
            rec["iter"] = current_iter

    # ---------------------------- interfaces -------------------------------

    def validation(
        self, dataloader, current_iter: int, tb_logger=None, save_img: bool = False
    ) -> None:
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img) -> None:
        raise NotImplementedError
