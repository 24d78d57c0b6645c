"""Validation metric dispatch (parity: the JAX package's metrics/__init__.py)."""

from __future__ import annotations

from typing import Any

from trainner_redux_tpu_torch.metrics import psnr_ssim  # noqa: F401 (registers metrics)
from trainner_redux_tpu_torch.utils.registry import METRIC_REGISTRY

__all__ = ["calculate_metric", "METRIC_REGISTRY"]


def calculate_metric(data: dict[str, Any], opt: dict[str, Any]) -> float:
    """data: kwargs for the metric fn (img, img2, ...); opt: {'type': ..., **kwargs}."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    name = metric_type if metric_type.startswith("calculate_") else f"calculate_{metric_type}"
    return METRIC_REGISTRY.get(name)(**data, **opt)
