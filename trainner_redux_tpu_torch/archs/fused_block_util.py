"""Shared wiring for the fused block kernels (port of the JAX package's
archs/fused_block_util.py): the per-sample DropPath scale the kernels take."""

from __future__ import annotations

import torch


def droppath_scale(rate: float, train: bool, batch: int, device=None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample DropPath keep scale (0 or 1/keep); ones at eval or rate 0
    (the form the fused kernels consume, equivalent to the DropPath module's
    (B,1,1,1) mask).

    The masks are drawn from `generator` only, as the JAX package draws them
    from its explicit `dropout` key: torch's global generator is never read,
    so a drop rate in training without a generator raises."""
    if rate > 0.0 and train:
        if generator is None:
            raise ValueError("DropPath in training needs an explicit torch.Generator")
        keep = 1.0 - rate
        probs = torch.full((batch,), keep, device=device)
        return torch.bernoulli(probs, generator=generator) / keep
    return torch.ones((batch,), dtype=torch.float32, device=device)
