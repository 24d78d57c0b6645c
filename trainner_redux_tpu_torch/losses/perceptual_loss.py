"""The VGG perceptual loss, with its style (Gram) term (port of the JAX
package's losses/perceptual_loss.py): weighted per-layer distances between
the VGG features of the output and of the target (criterion l1, l2 / mse,
charbonnier, huber, or `fro`, the Frobenius norm of each sample's
difference, averaged), plus `style_weight` times the same over the layers'
Gram matrices. The target's features take no gradient. `perceptualfp16loss`
is the same loss."""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.archs.vgg_arch import VGGFeatureExtractor
from trainner_redux_tpu_torch.losses.loss_util import get_criterion
from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY


def _gram(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C, C) Gram matrix over C * H * W."""
    n, c, h, w = x.shape
    f = x.reshape(n, c, h * w)
    return f @ f.transpose(1, 2) / (c * h * w)


def _default_layer_weights() -> dict[str, float]:
    return {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0, "conv4_4": 1.0, "conv5_4": 1.0}


@LOSS_REGISTRY.register(name="perceptualloss")
class PerceptualLoss:
    def __init__(self, loss_weight: float = 1.0, layer_weights: dict[str, float] | None = None,
                 vgg_type: str = "vgg19", use_input_norm: bool = True, range_norm: bool = False,
                 perceptual_weight: float | None = None, style_weight: float = 0.0,
                 criterion: str = "l1", weights_path: str | None = None, **_) -> None:
        # loss_weight (new style) or perceptual_weight (legacy) scales
        self.loss_weight = loss_weight if perceptual_weight is None else perceptual_weight
        self.layer_weights = dict(layer_weights or _default_layer_weights())
        self.style_weight = style_weight
        self.criterion_type = criterion
        self.criterion = None if criterion == "fro" else get_criterion(criterion)
        self.vgg = VGGFeatureExtractor(list(self.layer_weights), vgg_type, use_input_norm,
                                       range_norm, weights_path)

    def _dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.criterion_type == "fro":
            return torch.linalg.vector_norm((a - b).reshape(a.shape[0], -1), dim=-1).mean()
        return self.criterion(a, b)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.vgg.mean.device != pred.device:
            self.vgg.to(pred.device)
        pred_f = self.vgg(pred.float())
        with torch.no_grad():
            gt_f = self.vgg(target.float())
        percep = sum(w * self._dist(pred_f[k], gt_f[k]) for k, w in self.layer_weights.items())
        total = self.loss_weight * percep
        if self.style_weight > 0:
            style = sum(w * self._dist(_gram(pred_f[k]), _gram(gt_f[k]))
                        for k, w in self.layer_weights.items())
            total = total + self.style_weight * style
        return total


LOSS_REGISTRY.register(PerceptualLoss, name="perceptualfp16loss")
