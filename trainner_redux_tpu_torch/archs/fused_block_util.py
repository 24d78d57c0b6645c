"""Shared wiring for the fused block kernels (port of the JAX package's
archs/fused_block_util.py): the per-sample DropPath scale the kernels take,
and the pre-LN MLP half `x + DropPath(fc2(gelu(fc1(LN(x)))))` that archs
across the zoo share (HAT's HAB and OCAB here), as one `fused_ln_mlp` call
on the modules' own parameters (official key names unchanged)."""

from __future__ import annotations

import torch
from torch import nn

from trainner_redux_tpu_torch.ops.fused_block import fused_ln_mlp, fused_mlp_supported


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


def fused_mlp_residual(x: torch.Tensor, norm: nn.LayerNorm, fc1: nn.Linear, fc2: nn.Linear,
                       drop_path: float, train: bool, rows: int,
                       generator: torch.Generator | None = None) -> torch.Tensor | None:
    """x + DropPath(fc2(gelu(fc1(norm(x))))) through `fused_ln_mlp`, or None
    when `fused_mlp_supported` says no (the caller runs its modules). `rows`
    is the strip height the gate checks H against (archs pass their window
    size); x is NHWC, in the network's compute dtype: a bf16 x (a bf16
    training forward) runs the bf16 forms of #2/#7, from the fp32
    parameters, as the JAX package passes `x.astype(dtype)`."""
    b, h, w, c = x.shape
    if not fused_mlp_supported(h, w, rows, c, fc1.out_features, train):
        return None
    s = droppath_scale(drop_path, train, b, x.device, generator)
    return fused_ln_mlp(
        x.contiguous(), norm.weight, norm.bias, fc1.weight.t().contiguous(), fc1.bias,
        fc2.weight.t().contiguous(), fc2.bias, s, rows, norm.eps,
    )
