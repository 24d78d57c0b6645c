"""Loss helpers: reductions, the pixel criteria and average pooling (port
of the JAX package's losses/loss_util.py; images are NCHW here)."""

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


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """NCHW average pooling with stride k (torch AvgPool2d(kernel_size=k));
    a ragged last row or column is dropped."""
    n, c, h, w = x.shape
    x = x[:, :, : h - h % k, : w - w % k]
    return x.reshape(n, c, x.shape[2] // k, k, x.shape[3] // k, k).mean(dim=(3, 5))
