"""Shared wiring for the fused block kernels (port of the JAX package's
archs/fused_block_util.py): the per-sample DropPath scale the kernels take."""

from __future__ import annotations

import torch


def droppath_scale(rate: float, train: bool, batch: int, device=None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample DropPath keep scale (0 or 1/keep); ones at eval or rate 0
    (the form the fused kernels consume, equivalent to the DropPath module's
    (B,1,1,1) mask)."""
    if rate > 0.0 and train:
        keep = 1.0 - rate
        probs = torch.full((batch,), keep, device=device)
        return torch.bernoulli(probs, generator=generator) / keep
    return torch.ones((batch,), dtype=torch.float32, device=device)
