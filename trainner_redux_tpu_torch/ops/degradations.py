"""On-device degradation operators (port of the JAX package's
ops/degradations.py): plain functions on NHWC float tensors in [0, 1].

Where the JAX operator draws from a key, the port's takes what was drawn:
the noise tensors, the aliasing bucket, the crop offsets. The caller
(`models/realesrgan_model.py`) draws them from its generators, so each
operator is a pure function of its inputs and can be held against the JAX
one on the same inputs and the same noise.

`filter2d` cross-correlates (as the JAX convolution does) after a reflect
pad of k // 2: with per-sample kernels it is one grouped `conv2d` of B * C
groups.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from trainner_redux_tpu_torch.archs.arch_util import bilinear_sample
from trainner_redux_tpu_torch.ops.resize import gaussian_blur, resize
from trainner_redux_tpu_torch.utils.diffjpeg import diff_jpeg

ALIASING_BUCKETS = 4


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _depthwise3(x: torch.Tensor, kernel: list[list[float]]) -> torch.Tensor:
    """One 3x3 kernel on every channel of NHWC `x`, zero padding 1."""
    c = x.shape[-1]
    k = torch.tensor(kernel, dtype=x.dtype, device=x.device).expand(c, 1, 3, 3)
    return _nhwc(F.conv2d(_nchw(x), k, padding=1, groups=c))


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------


def filter2d(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """A per-sample 2D kernel on every channel. img (B, H, W, C); kernels
    (B, k, k) or (k, k), k odd."""
    b, h, w, c = img.shape
    if kernels.ndim == 2:
        kernels = kernels.expand(b, *kernels.shape)
    k = kernels.shape[-1]
    pad = k // 2
    x = F.pad(_nchw(img), (pad, pad, pad, pad), mode="reflect").reshape(1, b * c, h + 2 * pad,
                                                                        w + 2 * pad)
    weight = kernels.to(img.dtype)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    return _nhwc(F.conv2d(x, weight, groups=b * c).reshape(b, c, h, w))


def usm_sharpen(img: torch.Tensor, weight=0.5, radius: int = 13,
                threshold: float = 10 / 255) -> torch.Tensor:
    """Unsharp masking with a soft threshold mask (upstream USMSharp)."""
    k = radius | 1
    blur = gaussian_blur(img, kernel_size=k, sigma=k / 6.0)
    residual = img - blur
    mask = (residual.abs() > threshold).to(img.dtype)
    soft_mask = gaussian_blur(mask, kernel_size=k, sigma=k / 6.0)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img


# ---------------------------------------------------------------------------
# noise (the noise tensors are drawn by the caller)
# ---------------------------------------------------------------------------


def add_gaussian_noise(img: torch.Tensor, noise_c: torch.Tensor, noise_g: torch.Tensor,
                       sigma: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """Per-sample Gaussian noise: noise_c (B, H, W, C) and noise_g
    (B, H, W, 1) standard normal, sigma (B,) on the [0, 1] scale, gray (B,)
    bool picks the grey noise."""
    noise = torch.where(gray[:, None, None, None], noise_g, noise_c)
    return torch.clamp(img + noise * sigma[:, None, None, None], 0.0, 1.0)


def add_poisson_noise(img: torch.Tensor, gauss_c: torch.Tensor, gauss_g: torch.Tensor,
                      scale: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    """Per-sample shot noise in the Gaussian approximation Poisson(lam x) /
    lam ~ x + sqrt(x / lam) N(0, 1), lam = 2^9; gauss_c (B, H, W, C) and
    gauss_g (B, H, W, 1) standard normal, scale (B,), gray (B,) bool."""
    g = gray[:, None, None, None]
    gauss = torch.where(g, gauss_g, gauss_c)
    base = torch.where(g, img.mean(dim=-1, keepdim=True), img)
    shot = torch.sqrt(torch.clamp(base, 1e-8, 1.0) / 2.0**9) * gauss
    return torch.clamp(img + shot * scale[:, None, None, None], 0.0, 1.0)


def apply_sensor_noise(img: torch.Tensor, shot: torch.Tensor, read: torch.Tensor,
                       std: torch.Tensor) -> torch.Tensor:
    """Luminance-dependent sensor noise: shot (sqrt-signal) plus a read
    floor; shot and read are standard normal of img's shape, std
    (B, 1, 1, 1)."""
    luma = img.mean(dim=-1, keepdim=True)
    shot = shot * torch.sqrt(torch.clamp(luma, 1e-6, 1.0))
    return torch.clamp(img + std * (shot + read * 0.3), 0.0, 1.0)


# ---------------------------------------------------------------------------
# optics / sensor / ISP operators (the Paragon set)
# ---------------------------------------------------------------------------


def apply_exposure(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * factor, 0.0, 1.0)


def apply_color_temperature(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """shift (B, 1, 1) in [-1, 1]: negative cooler (more blue), positive
    warmer (more red)."""
    r = img[..., 0] * (1.0 + 0.3 * shift)
    g = img[..., 1]
    b = img[..., 2] * (1.0 - 0.3 * shift)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def apply_oversharpen(img: torch.Tensor, strength) -> torch.Tensor:
    """USM-style oversharpening with halos (strength >= 1)."""
    blur = gaussian_blur(img, kernel_size=5, sigma=1.0)
    return torch.clamp(img + strength * (img - blur), 0.0, 1.0)


def apply_rolling_shutter(img: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """Per-row horizontal shear (CMOS readout skew); strength (B, 1), a
    fraction of the width across the frame height."""
    b, h, w, _ = img.shape
    rows = torch.arange(h, dtype=img.dtype, device=img.device) / max(h - 1, 1)
    shift = strength * rows[None, :] * w  # (B, H) pixels
    cols = torch.arange(w, dtype=img.dtype, device=img.device)[None, None, :]
    src_x = cols - shift[:, :, None]
    src_y = torch.arange(h, dtype=img.dtype, device=img.device)[None, :, None].expand(b, h, w)
    return bilinear_sample(img, src_y, torch.clamp(src_x, 0, w - 1))


def apply_lens_distortion(img: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """Radial barrel / pincushion distortion r' = r (1 + k r^2); strength
    (B,)."""
    b, h, w, _ = img.shape
    yy = (torch.arange(h, dtype=img.dtype, device=img.device) - (h - 1) / 2) / ((h - 1) / 2)
    xx = (torch.arange(w, dtype=img.dtype, device=img.device) - (w - 1) / 2) / ((w - 1) / 2)
    gy, gx = yy[:, None].expand(h, w), xx[None, :].expand(h, w)
    factor = 1.0 + strength.reshape(b, 1, 1) * (gx**2 + gy**2)[None]
    src_y = (gy[None] * factor + 1.0) * (h - 1) / 2
    src_x = (gx[None] * factor + 1.0) * (w - 1) / 2
    return bilinear_sample(img, torch.clamp(src_y, 0, h - 1), torch.clamp(src_x, 0, w - 1))


def apply_chromatic_aberration(img: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """Lateral CA: the R and B channels scaled radially in opposite
    directions; strength (B,)."""
    b, h, w, _ = img.shape
    yy = torch.arange(h, dtype=img.dtype, device=img.device) - (h - 1) / 2
    xx = torch.arange(w, dtype=img.dtype, device=img.device) - (w - 1) / 2
    out = []
    for ci, s in ((0, 1.0), (1, 0.0), (2, -1.0)):
        scale = 1.0 + strength.reshape(b, 1, 1) * 0.002 * s
        gy = yy[:, None].expand(h, w)[None] * scale + (h - 1) / 2
        gx = xx[None, :].expand(h, w)[None] * scale + (w - 1) / 2
        out.append(bilinear_sample(img[..., ci : ci + 1], torch.clamp(gy, 0, h - 1),
                                   torch.clamp(gx, 0, w - 1)))
    return torch.cat(out, dim=-1)


def motion_blur_kernel(kernel_size: int, angle: torch.Tensor) -> torch.Tensor:
    """Line kernels at `angle` degrees ((B,) or a scalar) rasterized with
    soft coverage: (B, k, k), or (k, k) for a scalar angle."""
    k = kernel_size
    theta = torch.deg2rad(torch.as_tensor(angle, dtype=torch.float32))[..., None, None]
    c = (k - 1) / 2
    ys = torch.arange(k, dtype=torch.float32, device=theta.device) - c
    gy, gx = ys[:, None].expand(k, k), ys[None, :].expand(k, k)
    # distance from the line through the centre with direction (cos, sin)
    d_perp = torch.abs(-torch.sin(theta) * gx + torch.cos(theta) * gy)
    d_par = torch.abs(torch.cos(theta) * gx + torch.sin(theta) * gy)
    mask = torch.clamp(1.0 - d_perp, 0.0, 1.0) * (d_par <= c + 0.5)
    return mask / torch.clamp(mask.sum(dim=(-2, -1), keepdim=True), min=1e-8)


def apply_demosaic_artifacts(img: torch.Tensor) -> torch.Tensor:
    """A Bayer mosaic (RGGB) and a naive normalised 3x3 box demosaic (zipper
    and maze artifacts)."""
    _, h, w, _ = img.shape
    gy = (torch.arange(h, device=img.device) % 2)[:, None].expand(h, w)
    gx = (torch.arange(w, device=img.device) % 2)[None, :].expand(h, w)
    masks = [((gy == 0) & (gx == 0)), ((gy == 0) & (gx == 1)) | ((gy == 1) & (gx == 0)),
             ((gy == 1) & (gx == 1))]
    masks = [m.to(img.dtype)[None, :, :, None] for m in masks]
    mosaic = img[..., 0:1] * masks[0] + img[..., 1:2] * masks[1] + img[..., 2:3] * masks[2]
    ones = torch.ones(1, 1, 3, 3, dtype=img.dtype, device=img.device)

    def interp(mask):
        num = F.conv2d(_nchw(mosaic * mask), ones, padding=1)
        den = F.conv2d(_nchw(mask.expand(mosaic.shape)), ones, padding=1)
        return _nhwc(num / torch.clamp(den, min=1e-8))

    return torch.clamp(torch.cat([interp(m) for m in masks], dim=-1), 0.0, 1.0)


def aliasing_scale(scale_range: tuple[float, float], bucket: int) -> float:
    """The scale of aliasing bucket `bucket` of ALIASING_BUCKETS."""
    lo, hi = scale_range
    return lo + (hi - lo) * (bucket + 0.5) / ALIASING_BUCKETS


def apply_aliasing(img: torch.Tensor, scale_range: tuple[float, float],
                   bucket: int) -> torch.Tensor:
    """Nearest down then up at the scale of aliasing bucket `bucket` (the
    JAX package draws the bucket from its key)."""
    _, h, w, _ = img.shape
    s = aliasing_scale(scale_range, bucket)
    down = resize(img, (max(8, round(h * s)), max(8, round(w * s))), mode="nearest",
                  antialias=False)
    return resize(down, (h, w), mode="nearest", antialias=False)


def round_to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Clamp and 8-bit rounding: clamp(round(x * 255), 0, 255) / 255."""
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0) / 255.0


def paired_random_crop_device(gt: torch.Tensor, lq: torch.Tensor, gt_patch: int, scale: int,
                              top: int, left: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same crop for the whole batch, at LQ offsets (top, left) drawn by
    the caller in [0, h_lq - lq_patch] and [0, w_lq - lq_patch]."""
    lq_patch = gt_patch // scale
    lq_c = lq[:, top : top + lq_patch, left : left + lq_patch]
    gt_c = gt[:, top * scale : top * scale + gt_patch, left * scale : left * scale + gt_patch]
    return gt_c, lq_c


def compress_jpeg_like(img: torch.Tensor, quality: torch.Tensor,
                       quality_offset: float = 0.0) -> torch.Tensor:
    """DiffJPEG at the per-sample `quality` (B,) plus `quality_offset`,
    clipped to [1, 100]. WebP, AVIF and HEIF are this surrogate at a
    quality offset (the JAX package's policy): a modern codec at q looks
    roughly like JPEG at q + offset."""
    return diff_jpeg(img, torch.clamp(quality + quality_offset, 1.0, 100.0))


def diff_jpeg_clip(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """DiffJPEG at per-sample quality, clipped to [0, 1]."""
    return torch.clamp(diff_jpeg(img, quality), 0.0, 1.0)


def apply_block_artifacts(img: torch.Tensor, strength) -> torch.Tensor:
    """Codec blocking surrogate: upstream quantises every 8x8 block with the
    same uniform step, which is per-pixel quantisation with step s / 255."""
    s = torch.as_tensor(strength, dtype=img.dtype, device=img.device)
    return torch.clamp(torch.round(img * (255.0 / s)) * (s / 255.0), 0.0, 1.0)


def apply_color_banding(img: torch.Tensor, bit_depth) -> torch.Tensor:
    """Bit-depth reduction: quantise to 2**bits levels."""
    levels = torch.as_tensor(2.0, dtype=img.dtype) ** torch.as_tensor(bit_depth, dtype=img.dtype)
    levels = levels.to(img.device)
    return torch.clamp(torch.round(img * (levels - 1)) / (levels - 1), 0.0, 1.0)


def apply_ringing(img: torch.Tensor, strength) -> torch.Tensor:
    """Edge ringing / overshoot: sobel-x edges, the [[0,-1,0],[-1,5,-1],
    [0,-1,0]] / 5 oscillation kernel on |edges|, added back with the edge's
    sign."""
    sobel = [[-1 / 8, 0.0, 1 / 8], [-2 / 8, 0.0, 2 / 8], [-1 / 8, 0.0, 1 / 8]]
    ring = [[0.0, -1 / 5, 0.0], [-1 / 5, 1.0, -1 / 5], [0.0, -1 / 5, 0.0]]
    edges = _depthwise3(img, sobel)
    s = torch.as_tensor(strength, dtype=img.dtype, device=img.device)
    return torch.clamp(img + _depthwise3(edges.abs(), ring) * s * torch.sign(edges), 0.0, 1.0)


def apply_video_codec_artifacts(img: torch.Tensor, crf) -> torch.Tensor:
    """H.264/H.265-class compression surrogate: CRF maps to a DiffJPEG
    quality (CRF 18 ~ q90, CRF 35 ~ q30), then the blocking that codecs show
    at higher CRF."""
    crf = torch.as_tensor(crf, dtype=torch.float32, device=img.device)
    q = torch.clamp(140.0 - 3.2 * crf, 10.0, 95.0)
    out = diff_jpeg(img, q.expand(img.shape[0]))
    return apply_block_artifacts(torch.clamp(out, 0.0, 1.0), torch.clamp(0.6 * crf - 8.0, 2.0, 20.0))
