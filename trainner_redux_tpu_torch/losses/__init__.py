"""Loss registry: build_loss and the log keys (port of the JAX package's
losses/__init__.py). Ported: the pixel losses of `basic_loss.py`, the
SSIM / MS-SSIM losses of `mssim_loss.py`, the VGG perceptual loss, the GAN
losses, `hsluvloss` (a dict of hue, saturation and lightness terms) and
`cosimloss`; any other type, and the iterative schedule parameters,
raise."""

from __future__ import annotations

from typing import Any

from trainner_redux_tpu_torch.losses import (  # noqa: F401 (registers)
    basic_loss,
    gan_loss,
    hsluv_loss,
    misc_losses_loss,
    mssim_loss,
    perceptual_loss,
)
from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY

__all__ = ["build_loss", "loss_log_key", "LOSS_REGISTRY"]

SCHEDULE_PARAMS = (
    "start_iter", "target_iter", "target_weight", "disable_after", "schedule_type",
    "warn_on_unused", "loss_decay", "loss_decay_inflection",
)


# left out of the port on purpose, and why
LEFT_OUT = {
    "r3ganloss": "its R1/R2 gradient penalties need a double backward",
    "multiscaler3ganloss": "its R1/R2 gradient penalties need a double backward",
    "featurematchingloss": "it needs the discriminator's features in the generator step",
}


def build_loss(loss_opt: dict[str, Any]):
    opt = dict(loss_opt)
    loss_type = str(opt.pop("type"))
    scheduled = sorted(p for p in SCHEDULE_PARAMS if p in opt)
    if scheduled:
        raise NotImplementedError(
            f"loss schedule parameters {scheduled} are not ported to torch yet"
        )
    if loss_type.lower() in LEFT_OUT:
        raise NotImplementedError(
            f"loss '{loss_type}' is not ported to torch yet: {LEFT_OUT[loss_type.lower()]} "
            "(ROADMAP.md, section 1)"
        )
    if loss_type not in LOSS_REGISTRY:
        raise NotImplementedError(
            f"loss '{loss_type}' is not ported to torch yet "
            f"(ported: {', '.join(LOSS_REGISTRY.keys())})"
        )
    return LOSS_REGISTRY.get(loss_type)(**opt)


def loss_log_key(loss, loss_type: str | None = None) -> str:
    """Console key for a loss instance, e.g. 'l_g_l1'."""
    name = (loss_type or type(loss).__name__).lower()
    return f"l_g_{name.removesuffix('loss')}"
