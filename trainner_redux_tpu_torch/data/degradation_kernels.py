"""Host-side random blur-kernel synthesis (numpy; port of the JAX
package's data/degradation_kernels.py, kept as its own copy).

Kernels are tiny (at most 21x21), so synthesis stays on the host with an
explicit numpy Generator, drawing in the JAX package's order: the same
generator gives the same kernels bit for bit. The batch of kernels goes to
the device, where the filtering runs (ops/degradations.py). scipy is imported
where the sinc kernel needs it.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np


def _mesh_grid(kernel_size: int) -> np.ndarray:
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)  # (K, K, 2)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quad_form(grid: np.ndarray, sigma_matrix: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma_matrix)
    return np.sum((grid @ inv) * grid, axis=2)


def bivariate_gaussian(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, isotropic: bool = True
) -> np.ndarray:
    grid = _mesh_grid(kernel_size)
    sm = (
        np.array([[sig_x**2, 0.0], [0.0, sig_x**2]])
        if isotropic
        else _sigma_matrix(sig_x, sig_y, theta)
    )
    kernel = np.exp(-0.5 * _quad_form(grid, sm))
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    grid = _mesh_grid(kernel_size)
    sm = (
        np.array([[sig_x**2, 0.0], [0.0, sig_x**2]])
        if isotropic
        else _sigma_matrix(sig_x, sig_y, theta)
    )
    kernel = np.exp(-0.5 * np.power(_quad_form(grid, sm), beta))
    return kernel / kernel.sum()


def bivariate_plateau(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    grid = _mesh_grid(kernel_size)
    sm = (
        np.array([[sig_x**2, 0.0], [0.0, sig_x**2]])
        if isotropic
        else _sigma_matrix(sig_x, sig_y, theta)
    )
    kernel = 1.0 / (np.power(_quad_form(grid, sm), beta) + 1.0)
    return kernel / kernel.sum()


def _sample_sigmas(
    rng: np.random.Generator,
    sigma_x_range: tuple[float, float],
    sigma_y_range: tuple[float, float],
    rotation_range: tuple[float, float],
    isotropic: bool,
) -> tuple[float, float, float]:
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    return sigma_x, rng.uniform(*sigma_y_range), rng.uniform(*rotation_range)


def _sample_beta(rng: np.random.Generator, beta_range: tuple[float, float]) -> float:
    # reference: with p=0.5 sample below 1 (if range allows), else above 1
    if rng.uniform() < 0.5 and beta_range[0] < 1:
        return rng.uniform(beta_range[0], 1.0)
    return rng.uniform(max(1.0, beta_range[0]), beta_range[1])


def random_mixed_kernels(
    rng: np.random.Generator,
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int = 21,
    sigma_x_range: tuple[float, float] = (0.6, 5),
    sigma_y_range: tuple[float, float] = (0.6, 5),
    rotation_range: tuple[float, float] = (-math.pi, math.pi),
    betag_range: tuple[float, float] = (0.5, 8),
    betap_range: tuple[float, float] = (0.5, 8),
    noise_range: tuple[float, float] | None = None,
) -> np.ndarray:
    kernel_type = rng.choice(kernel_list, p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    iso = kernel_type.endswith("iso") and "aniso" not in kernel_type
    sx, sy, rot = _sample_sigmas(rng, sigma_x_range, sigma_y_range, rotation_range, iso)
    if kernel_type in ("iso", "aniso"):
        kernel = bivariate_gaussian(kernel_size, sx, sy, rot, isotropic=iso)
    elif kernel_type in ("generalized_iso", "generalized_aniso"):
        kernel = bivariate_generalized_gaussian(
            kernel_size, sx, sy, rot, _sample_beta(rng, betag_range), isotropic=iso
        )
    elif kernel_type in ("plateau_iso", "plateau_aniso"):
        kernel = bivariate_plateau(
            kernel_size, sx, sy, rot, _sample_beta(rng, betap_range), isotropic=iso
        )
    else:
        raise ValueError(f"Unknown kernel type {kernel_type}")
    if noise_range is not None and kernel_type in ("iso", "aniso", "generalized_iso", "generalized_aniso"):
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1], kernel.shape)
    return (kernel / kernel.sum()).astype(np.float32)


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2D circularly-symmetric sinc low-pass filter (jinc)."""
    from scipy import special

    assert kernel_size % 2 == 1
    c = (kernel_size - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = np.fromfunction(
            lambda x, y: cutoff
            * special.j1(cutoff * np.sqrt((x - c) ** 2 + (y - c) ** 2))
            / (2 * np.pi * np.sqrt((x - c) ** 2 + (y - c) ** 2)),
            [kernel_size, kernel_size],
        )
    kernel[int(c), int(c)] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel.astype(np.float32)
