"""HSLuv colour space on tensors (port of the JAX package's utils/hsluv.py,
itself a vectorised port of the hsluv reference algorithm).

HSLuv is CIELCh(uv) with the saturation normalised by the largest in-gamut
chroma at the pixel's hue and lightness: H in [0, 360), S and L in
[0, 100]. Colours are on the last axis, as in the JAX package.

Where the JAX function divides by a quantity its `where` then discards
(the u'v' divider of black, a zero chroma in `hypot` and `atan2`), the
division here takes a safe denominator, so that the discarded branch has no
NaN gradient to leak through `torch.where`; the values are the JAX
function's. (The JAX function's gradient is NaN at a grey pixel, where
u = v = 0: ROADMAP.md section 3.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the hsluv reference's sRGB matrix (XYZ -> linear sRGB rows)
_M = np.array(
    [
        [3.240969941904521, -1.537383177570093, -0.498610760293],
        [-0.96924363628087, 1.87596750150772, 0.041555057407175],
        [0.055630079696993, -0.20397695888897, 1.056971514242878],
    ],
    dtype=np.float64,
)
_M_INV_T = np.linalg.inv(_M).T
_KAPPA = 903.2962962
_EPSILON = 0.0088564516
_REF_U = 0.19783000664283
_REF_V = 0.46831999493879


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] sRGB in [0, 1] -> XYZ (the inverse of the hsluv matrix)."""
    return _srgb_to_linear(rgb) @ torch.as_tensor(_M_INV_T, dtype=rgb.dtype, device=rgb.device)


def _y_to_l(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y <= _EPSILON, y * _KAPPA,
                       116.0 * y.clamp_min(1e-12) ** (1.0 / 3.0) - 16.0)


def _hypot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sqrt(u^2 + v^2) as jnp.hypot computes it: big * sqrt(1 + (small /
    big)^2), 0 where both are 0."""
    a, b = u.abs(), v.abs()
    big, small = torch.maximum(a, b), torch.minimum(a, b)
    zero = big == 0
    r = small / torch.where(zero, torch.ones_like(big), big)
    return torch.where(zero, big, big * torch.sqrt(1.0 + r * r))


def rgb_to_lch(rgb: torch.Tensor) -> torch.Tensor:
    xyz = rgb_to_xyz(rgb)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    l_val = _y_to_l(y)
    divider = x + 15.0 * y + 3.0 * z
    ok = divider > 1e-12
    safe = torch.where(ok, divider, torch.ones_like(divider))
    var_u = torch.where(ok, 4.0 * x / safe, torch.full_like(x, _REF_U))
    var_v = torch.where(ok, 9.0 * y / safe, torch.full_like(y, _REF_V))
    u = 13.0 * l_val * (var_u - _REF_U)
    v = 13.0 * l_val * (var_v - _REF_V)
    c = _hypot(u, v)
    grey = c < 1e-8  # no hue; atan2's gradient at (0, 0) would be NaN
    h = torch.atan2(v, torch.where(grey, torch.ones_like(u), u)) * (180.0 / math.pi)
    h = torch.where(h < 0, h + 360.0, h)
    h = torch.where(grey, torch.zeros_like(h), h)
    return torch.stack([l_val, c, h], dim=-1)


def _max_chroma_for_lh(l_val: torch.Tensor, h_deg: torch.Tensor) -> torch.Tensor:
    """The shortest positive ray to the six sRGB gamut boundary lines."""
    hrad = h_deg * (math.pi / 180.0)
    sin_h, cos_h = torch.sin(hrad), torch.cos(hrad)
    sub1 = ((l_val + 16.0) ** 3) / 1560896.0
    sub2 = torch.where(sub1 > _EPSILON, sub1, l_val / _KAPPA)
    lengths = []
    for m1, m2, m3 in _M:
        for t in (0.0, 1.0):
            top1 = (284517.0 * m1 - 94839.0 * m3) * sub2
            top2 = ((838422.0 * m3 + 769860.0 * m2 + 731718.0 * m1) * l_val * sub2
                    - 769860.0 * t * l_val)
            bottom = (632260.0 * m3 - 126452.0 * m2) * sub2 + 126452.0 * t
            slope, intercept = top1 / bottom, top2 / bottom
            denom = sin_h - slope * cos_h
            length = intercept / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                                             denom)
            lengths.append(torch.where(length >= 0, length, torch.full_like(length, math.inf)))
    return torch.stack(lengths, dim=0).amin(dim=0)


def rgb_to_hsluv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] sRGB in [0, 1] -> HSLuv (H 0-360, S 0-100, L 0-100)."""
    lch = rgb_to_lch(rgb)
    l_val, c, h = lch[..., 0], lch[..., 1], lch[..., 2]
    max_chroma = _max_chroma_for_lh(l_val.clamp(1e-4, 100.0 - 1e-4), h)
    s = torch.where((l_val > 100.0 - 1e-4) | (l_val < 1e-4), torch.zeros_like(c),
                    c / max_chroma.clamp_min(1e-8) * 100.0)
    return torch.stack([h, s.clamp(0.0, 100.0), l_val.clamp(0.0, 100.0)], dim=-1)
