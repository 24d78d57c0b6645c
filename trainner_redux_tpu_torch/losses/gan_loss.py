"""GAN losses (port of the JAX package's losses/gan_loss.py: GANLoss and
MultiScaleGANLoss).

`gan_type`: vanilla (binary cross-entropy on logits, in its stable form),
lsgan, wgan, wgan_softplus or hinge (the discriminator's relu(1 -+ pred),
the generator's -pred). The loss returns the unweighted value: the model
scales the generator's term by |loss_weight| and takes the
discriminator's at weight 1, as the JAX package does. A list of
predictions (a multi-scale discriminator's) gives the mean of each scale's
loss, each scale's last output taken where it is a list.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY

GAN_TYPES = ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge")


def _bce_with_logits(pred: torch.Tensor, target: float) -> torch.Tensor:
    return (pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()


@LOSS_REGISTRY.register(name="ganloss")
class GANLoss:
    def __init__(self, loss_weight: float = 1.0, gan_type: str = "vanilla",
                 real_label_val: float = 1.0, fake_label_val: float = 0.0) -> None:
        if gan_type not in GAN_TYPES:
            raise NotImplementedError(f"GAN type {gan_type} is not implemented.")
        self.gan_type = gan_type
        self.loss_weight = loss_weight
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val

    def _base(self, pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        label = self.real_label_val if target_is_real else self.fake_label_val
        if self.gan_type == "vanilla":
            return _bce_with_logits(pred, label)
        if self.gan_type == "lsgan":
            return ((pred - label) ** 2).mean()
        if self.gan_type == "wgan":
            return -pred.mean() if target_is_real else pred.mean()
        return F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()

    def __call__(self, pred, target_is_real: bool, is_disc: bool = False) -> torch.Tensor:
        if isinstance(pred, (list, tuple)):
            vals = [self(p[-1] if isinstance(p, (list, tuple)) else p, target_is_real, is_disc)
                    for p in pred]
            return sum(vals) / len(vals)
        pred = pred.float()
        if self.gan_type == "hinge":
            if is_disc:
                return torch.relu(1 + (-pred if target_is_real else pred)).mean()
            return -pred.mean()
        return self._base(pred, target_is_real)


@LOSS_REGISTRY.register(name="multiscaleganloss")
class MultiScaleGANLoss(GANLoss):
    """GANLoss over a list of scales (the list handling is GANLoss's)."""
