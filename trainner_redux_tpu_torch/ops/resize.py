"""Image resampling as matrix products, and the Gaussian blur (port of the
JAX package's ops/resize.py).

For static in and out sizes the separable resampling weights are computed on
the host in numpy (`_resize_matrix`, `_lowpass_matrix`, `_gaussian_kernel1d`,
the JAX package's own matrices), and the resize is two `torch.einsum`
contractions over NHWC images. `F.interpolate` is not used: its `nearest`
and bicubic sample other source pixels than these matrices do. Modes:
bilinear and bicubic (optionally antialiased), nearest, nearest-exact, area,
lanczos. Callers run in fp32 with TF32 off, as the JAX package's
`precision="highest"` products do.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

ANTIALIAS_MODES = {"bilinear", "bicubic"}


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


def _lanczos_kernel(x: np.ndarray, a: int = 3) -> np.ndarray:
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


_KERNELS = {
    "bicubic": (_cubic_kernel, 2.0),
    "bilinear": (_triangle_kernel, 1.0),
    "lanczos": (lambda x: _lanczos_kernel(x, 3), 3.0),
}


@lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str, antialias: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic resampling matrix."""
    if mode == "nearest-exact":
        w = np.zeros((out_size, in_size), dtype=np.float32)
        scale = in_size / out_size
        src = np.minimum((np.arange(out_size) + 0.5) * scale, in_size - 0.5).astype(int)
        w[np.arange(out_size), src] = 1.0
        return w
    if mode == "nearest":
        w = np.zeros((out_size, in_size), dtype=np.float32)
        scale = in_size / out_size
        src = np.minimum(np.floor(np.arange(out_size) * scale), in_size - 1).astype(int)
        w[np.arange(out_size), src] = 1.0
        return w
    if mode == "area":
        # overlap of output cell [i/s, (i+1)/s) with each input cell
        w = np.zeros((out_size, in_size), dtype=np.float64)
        scale = in_size / out_size
        for i in range(out_size):
            lo, hi = i * scale, (i + 1) * scale
            j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
            for j in range(j0, min(j1, in_size)):
                w[i, j] = min(hi, j + 1) - max(lo, j)
        w /= w.sum(axis=1, keepdims=True)
        return w.astype(np.float32)

    kernel, radius = _KERNELS[mode]
    scale = out_size / in_size
    # antialias widens the kernel support when downscaling
    filter_scale = max(1.0, 1.0 / scale) if antialias else 1.0
    support = radius * filter_scale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) / scale - 0.5
        j0 = int(np.floor(center - support)) + 1
        j1 = int(np.floor(center + support)) + 1
        taps = np.arange(j0, j1 + 1)
        vals = kernel((taps - center) / filter_scale)
        taps_c = np.clip(taps, 0, in_size - 1)
        for t, v in zip(taps_c, vals):
            w[i, t] += v
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@lru_cache(maxsize=64)
def _lowpass_matrix(in_size: int, out_size: int, a: int = 3) -> np.ndarray:
    """Same-size lanczos low-pass operator with reflect padding (as a
    matrix): the pre-filter of upstream's lanczos resize."""
    ratio = out_size / in_size
    # ramp of taps: symmetric multiples of ratio
    n = math.ceil(a / ratio + 1)
    ramp = np.arange(n) * ratio
    taps_x = np.concatenate([-ramp[1:][::-1], ramp])[1:-1]
    k = _lanczos_kernel(taps_x, a)
    k = k / k.sum()
    pad = (len(k) - 1) // 2
    m = np.zeros((in_size, in_size), dtype=np.float64)
    for i in range(in_size):
        for dj, kv in enumerate(k):
            j = i - pad + dj
            # reflect without repeating the edge (cv2 BORDER_REFLECT_101)
            if j < 0:
                j = -j
            if j >= in_size:
                j = 2 * in_size - 2 - j
            j = int(np.clip(j, 0, in_size - 1))
            m[i, j] += kv
    return m.astype(np.float32)


@lru_cache(maxsize=32)
def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_on_device: dict[tuple, torch.Tensor] = {}


def _device_array(fn, *args, device: torch.device) -> torch.Tensor:
    """`fn(*args)` (a cached numpy matrix) as a tensor on `device`, copied
    there once."""
    key = (fn.__name__, *args, str(device))
    t = _on_device.get(key)
    if t is None:
        if len(_on_device) >= 256:  # sequence plans draw blur sigmas at random
            _on_device.clear()
        t = torch.from_numpy(fn(*args)).to(device)
        _on_device[key] = t
    return t


def _rows(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("oh,nhwc->nowc", m, x)


def _cols(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ow,nhwc->nhoc", m, x)


def resize(x: torch.Tensor, size: tuple[int, int], mode: str = "bicubic",
           antialias: bool | None = None) -> torch.Tensor:
    """Resize NHWC float images to (out_h, out_w)."""
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    if antialias is None:
        antialias = mode in ANTIALIAS_MODES
    dev = x.device
    if mode == "lanczos":
        # lanczos3 low-pass only in the downscaled dims, then a bicubic
        # resample without antialias
        if oh < h:
            x = _rows(_device_array(_lowpass_matrix, h, oh, device=dev), x)
        if ow < w:
            x = _cols(_device_array(_lowpass_matrix, w, ow, device=dev), x)
        return resize(x, (oh, ow), mode="bicubic", antialias=False).clamp(0.0, 1.0)
    if oh != h:
        x = _rows(_device_array(_resize_matrix, h, oh, mode, antialias, device=dev), x)
    if ow != w:
        x = _cols(_device_array(_resize_matrix, w, ow, mode, antialias, device=dev), x)
    return x


def gaussian_blur(x: torch.Tensor, kernel_size: int = 5, sigma: float = 0.5) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images with reflect padding: two
    depthwise convolutions."""
    k = _device_array(_gaussian_kernel1d, kernel_size, float(sigma), device=x.device)
    pad = (kernel_size - 1) // 2
    c = x.shape[-1]
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(y, k.view(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size), groups=c)
    return y.permute(0, 2, 3, 1)
