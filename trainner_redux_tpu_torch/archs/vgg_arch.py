"""VGG feature extractor of the perceptual loss (port of the JAX package's
archs/vgg_arch.py).

VGG16 or VGG19 as torchvision lays it out (a `features` Sequential of
convolutions, ReLUs and 2x2 max pools), cut after the deepest requested
layer. `convX_Y` taps the convolution's output before its ReLU, `reluX_Y`
after it. Inputs in [0, 1] are normalised with ImageNet's mean and std
(`use_input_norm`); with `range_norm`, inputs in [-1, 1] are first mapped to
[0, 1].

The weights are torchvision's `vgg16.pth` / `vgg19.pth`, read from
`weights_path` or from `$TRAINNER_WEIGHTS_DIR`; nothing is downloaded.
Without them construction raises, as in the JAX package, unless a random
init is allowed (`allow_random_init`, or TRAINNER_ALLOW_RANDOM_VGG=1): then
each convolution is He-normal from `np.random.default_rng(seed)`, drawn in
the JAX package's order, so the two packages hold the same weights bit for
bit. The weights take no gradient.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch import nn

VGG19_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool3", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), ("pool4", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), ("pool5", 0),
]
VGG16_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("pool5", 0),
]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

RANDOM_VGG_WARNING = ("VGG weights not found (set TRAINNER_WEIGHTS_DIR or weights_path); "
                      "using random init: perceptual features are NOT meaningful.")


class VGGFeatureExtractor(nn.Module):
    def __init__(self, layer_name_list: list[str], vgg_type: str = "vgg19",
                 use_input_norm: bool = True, range_norm: bool = False,
                 weights_path: str | None = None, seed: int = 0,
                 allow_random_init: bool = False) -> None:
        super().__init__()
        if vgg_type not in ("vgg16", "vgg19"):
            raise NotImplementedError(f"vgg_type '{vgg_type}': vgg16 and vgg19 are ported")
        self.layer_name_list = list(layer_name_list)
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        cfg = VGG19_CFG if vgg_type == "vgg19" else VGG16_CFG
        names = [n for n, _ in cfg]
        last = max(names.index(n.replace("relu", "conv")) for n in self.layer_name_list)
        self.cfg = cfg[: last + 1]
        # torchvision's indices: conv, relu per conv layer; one per pool
        layers, self.names, in_ch = [], [], 3
        for name, ch in self.cfg:
            if name.startswith("pool"):
                layers.append(nn.MaxPool2d(2, 2))
                self.names.append(name)
            else:
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                self.names += [name, name.replace("conv", "relu")]
                in_ch = ch
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self._load_or_init(weights_path, seed, allow_random_init)
        self.requires_grad_(False)
        self.eval()

    def _load_or_init(self, weights_path: str | None, seed: int, allow_random: bool) -> None:
        path = weights_path
        if path is None and os.environ.get("TRAINNER_WEIGHTS_DIR"):
            cand = os.path.join(os.environ["TRAINNER_WEIGHTS_DIR"], f"{self.vgg_type}.pth")
            if os.path.exists(cand):
                path = cand
        if path and os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            own = self.state_dict()
            self.load_state_dict({k: sd[k] for k in own}, strict=True)
            return
        if not (allow_random or os.environ.get("TRAINNER_ALLOW_RANDOM_VGG") == "1"):
            raise FileNotFoundError(
                f"Pretrained {self.vgg_type} weights not found. Perceptual/LPIPS features "
                "from a randomly initialized VGG are meaningless; refusing to train against "
                "them. Provide the torchvision state dict via weights_path= or place "
                f"{self.vgg_type}.pth under $TRAINNER_WEIGHTS_DIR. For tests/experiments "
                "only, pass allow_random_init=True or set TRAINNER_ALLOW_RANDOM_VGG=1.")
        logging.getLogger("trainner_redux_tpu").warning(RANDOM_VGG_WARNING)
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    fan_in = 9 * m.in_channels
                    w = (rng.standard_normal((3, 3, m.in_channels, m.out_channels))
                         * (2.0 / fan_in) ** 0.5).astype(np.float32)
                    m.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: NCHW in [0, 1] (or [-1, 1] with range_norm) -> {layer: NCHW
        activation} for each requested layer."""
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        feats = {}
        for name, layer in zip(self.names, self.features):
            x = layer(x)
            if name in self.layer_name_list:
                feats[name] = x
        return feats
