"""The HSLuv colour loss (port of the JAX package's losses/hsluv_loss.py):
a dict of hue, saturation and lightness terms, which the model sums and
logs one by one (`l_g_hsluv_hue`, ...).

Images are NCHW here; the colour conversion takes them channels-last. The
bicubic downscale (`downscale_factor`) and the Gaussian blur
(`blur_strength`: kernel 4 * strength + 1, sigma strength) are the port's
ops/resize.py, as the JAX loss takes the JAX package's.
"""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.losses.loss_util import get_criterion
from trainner_redux_tpu_torch.ops.resize import gaussian_blur, resize
from trainner_redux_tpu_torch.utils.hsluv import rgb_to_hsluv
from trainner_redux_tpu_torch.utils.registry import LOSS_REGISTRY


@LOSS_REGISTRY.register(name="hsluvloss")
class HSLuvLoss:
    def __init__(self, loss_weight: float = 1.0, hue_weight: float = 1 / 3,
                 saturation_weight: float = 1 / 3, lightness_weight: float = 1 / 3,
                 criterion: str = "l1", downscale_factor: int = 1, blur_strength: int = 0) -> None:
        self.loss_weight = loss_weight
        self.hue_weight = hue_weight
        self.saturation_weight = saturation_weight
        self.lightness_weight = lightness_weight
        self.criterion = get_criterion(criterion)
        self.downscale_factor = downscale_factor
        self.blur_strength = blur_strength

    def _prep(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NHWC x -> its hue, saturation and lightness, each in [0, 1]."""
        if self.downscale_factor > 1:
            h, w = x.shape[1], x.shape[2]
            size = (h // self.downscale_factor, w // self.downscale_factor)
            x = resize(x, size, "bicubic", True).clamp(0.0, 1.0)
        hsl = rgb_to_hsluv(x.float().clamp(0.0, 1.0))
        return hsl[..., 0] / 360.0, hsl[..., 1] / 100.0, hsl[..., 2] / 100.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict[str, torch.Tensor]:
        x, y = x.permute(0, 2, 3, 1), y.permute(0, 2, 3, 1)
        if self.blur_strength:
            k = 4 * self.blur_strength + 1
            x = gaussian_blur(x, k, self.blur_strength)
            y = gaussian_blur(y, k, self.blur_strength)
        x_h, x_s, x_l = self._prep(x)
        y_h, y_s, y_l = self._prep(y)
        eps = 0.1
        zero = torch.zeros_like(x_h)

        d = (x_h - y_h).abs()
        hue_diff = torch.minimum(d, 1.0 - d) * 2.0
        hue_diff = torch.where((x_s < eps) & (y_s < eps), zero, hue_diff)
        hue_diff = torch.where(((x_s < eps) & (y_s > eps)) | ((x_s > eps) & (y_s < eps)),
                               torch.maximum(x_s, y_s), hue_diff)
        hue_diff = torch.where((x_l < eps) & (y_l < eps), zero, hue_diff)
        hue_diff = torch.where((x_l > 1 - eps) & (y_l > eps - 1), zero, hue_diff)
        hue_loss = hue_diff.mean() * self.hue_weight

        sat_diff = self.criterion(x_s, y_s, reduction="none")
        weight = (torch.minimum(x_l, 1 - x_l).clamp(0, 0.5)
                  + torch.minimum(y_l, 1 - y_l).clamp(0, 0.5))
        saturation_loss = (sat_diff * weight).mean() * self.saturation_weight

        lightness_loss = self.criterion(x_l, y_l, reduction="mean") * self.lightness_weight
        return {
            "hue": self.loss_weight * hue_loss,
            "saturation": self.loss_weight * saturation_loss,
            "lightness": self.loss_weight * lightness_loss,
        }
