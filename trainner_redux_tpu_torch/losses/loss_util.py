"""Loss helpers: reductions and the pixel criteria (port of the JAX
package's losses/loss_util.py)."""

from __future__ import annotations

import torch


def reduce_loss(loss: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"invalid reduction {reduction}")


def l1(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce_loss(torch.abs(pred - target), reduction)


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12,
                reduction: str = "mean") -> torch.Tensor:
    return reduce_loss(torch.sqrt((pred - target) ** 2 + eps), reduction)
