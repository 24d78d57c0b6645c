"""Pixel losses (port of the JAX package's losses/basic_loss.py: Loss,
L1Loss, CharbonnierLoss). Each loss is a callable returning
`loss_weight * value`; the layout of the images does not matter to them."""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.losses.loss_util import charbonnier, l1
from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY


class Loss:
    """Base: carries loss_weight; subclasses implement __call__(pred, target)."""

    def __init__(self, loss_weight: float = 1.0) -> None:
        self.loss_weight = loss_weight


@LOSS_REGISTRY.register(name="l1loss")
class L1Loss(Loss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean") -> None:
        super().__init__(loss_weight)
        self.reduction = reduction

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self.loss_weight * l1(pred, target, self.reduction)


@LOSS_REGISTRY.register(name="charbonnierloss")
class CharbonnierLoss(Loss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 eps: float = 1e-12) -> None:
        super().__init__(loss_weight)
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self.loss_weight * charbonnier(pred, target, self.eps, self.reduction)
