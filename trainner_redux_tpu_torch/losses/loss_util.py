"""Loss helpers: reductions, the pixel criteria, `get_criterion` and
average pooling (port of the JAX package's losses/loss_util.py; images are
NCHW here)."""

from __future__ import annotations

from collections.abc import Callable

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


def l2(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce_loss((pred - target) ** 2, reduction)


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12,
                reduction: str = "mean") -> torch.Tensor:
    return reduce_loss(torch.sqrt((pred - target) ** 2 + eps), reduction)


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0,
          reduction: str = "mean") -> torch.Tensor:
    diff = torch.abs(pred - target)
    loss = torch.where(diff <= delta, 0.5 * diff**2, delta * (diff - 0.5 * delta))
    return reduce_loss(loss, reduction)


def get_criterion(name: str) -> Callable:
    table = {"l1": l1, "l2": l2, "mse": l2, "charbonnier": charbonnier, "huber": huber}
    if name not in table:
        raise NotImplementedError(f"{name} criterion has not been supported.")
    return table[name]


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """NCHW average pooling with stride k (torch AvgPool2d(kernel_size=k));
    a ragged last row or column is dropped."""
    n, c, h, w = x.shape
    x = x[:, :, : h - h % k, : w - w % k]
    return x.reshape(n, c, x.shape[2] // k, k, x.shape[3] // k, k).mean(dim=(3, 5))
