"""BaseModel: device, weight flattening, best-metric bookkeeping, validation
dispatch.

Port of the evaluation half of the JAX package's models/base_model.py. The
JAX model places a parameter pytree on a device mesh; here the network is an
`nn.Module` on one explicit `torch.device`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trainner_redux_tpu_torch.utils.device import resolve_device
from trainner_redux_tpu_torch.utils.logger import get_root_logger
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions


class BaseModel:
    def __init__(self, opt: ReduxOptions, device: str | torch.device | None = None) -> None:
        self.opt = opt
        self.is_train = bool(opt.is_train)
        self.logger = get_root_logger()
        self.device = resolve_device(device)
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
