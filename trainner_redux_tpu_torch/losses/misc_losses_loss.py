"""The cosine-similarity loss (port of `cosimloss` of the JAX package's
losses/misc_losses_loss.py, the one loss of that file the port has).

The JAX loss takes the norm over the last axis, the channels of NHWC; the
port's images are NCHW, so here it is dim 1.
"""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY


@LOSS_REGISTRY.register(name="cosimloss")
class CosimLoss:
    """loss_weight * cosim_lambda * (1 - the mean cosine similarity of the
    pixels' channel vectors), each image clipped to [1e-12, 1] first."""

    def __init__(self, loss_weight: float = 1.0, cosim_lambda: float = 5) -> None:
        self.loss_weight = loss_weight
        self.cosim_lambda = cosim_lambda

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x.float().clamp(1e-12, 1.0)
        y = y.float().clamp(1e-12, 1.0)
        norms = torch.linalg.vector_norm(x, dim=1) * torch.linalg.vector_norm(y, dim=1)
        sim = (x * y).sum(dim=1) / norms.clamp_min(1e-20)
        return self.loss_weight * self.cosim_lambda * (1.0 - sim.mean())
