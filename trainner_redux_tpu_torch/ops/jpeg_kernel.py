"""The fused JPEG block transform (TPU kernel #15): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of the JAX package's ops/pallas/jpeg_kernel.py. Per flattened 8x8
block of blocks (B, N, 64), level-shifted spatial values in [-128, 127],
with the per-sample quantisation table qtabs (B, 64):

    c = x DCT^T;  y = c / qtab;  r = round(y);  q = r + (y - r)^3;
    out = (q * qtab) IDCT

(`utils/diffjpeg.py`'s `_dct_matrix` and `_idct_matrix_np`, (64, 64) each;
round to nearest, halves to even). DiffJPEG's `encode_decode` calls it once
per plane: Y, Cb and Cr.

On a CUDA tensor `jpeg_block_transform` launches `csrc/jpeg_block.cu`; on a
CPU tensor it runs `jpeg_block_transform_reference`, two einsums around the
quantisation, as the JAX package's `diff_jpeg` writes them. Anything else
raises. The kernel is forward only, as the JAX one is (no VJP): on the card
the wrapper refuses inputs that require a gradient. The CPU version stays
differentiable.

The differentiable round jumps at half-integers: r + (y - r)^3 is r + 1/8
just below r + 1/2 and r + 1 - 1/8 just above, so a coefficient within
rounding of a tie moves by 3/4 qtab between two summation orders.
`ties` marks such coefficients of an input.
"""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.ops.fused_block import _launch
from trainner_redux_tpu_torch.ops.window_attention import _check_cuda

LIB = "jpeg_block"

_matrices_on: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def dct_matrices(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(DCT, IDCT, DCT transposed), (64, 64) fp32 each, contiguous, on
    `device` (copied there once)."""
    from trainner_redux_tpu_torch.utils.diffjpeg import _dct_matrix, _idct_matrix_np

    key = str(torch.device(device))
    m = _matrices_on.get(key)
    if m is None:
        # _idct_matrix_np() is a transpose, column-major in numpy: the kernel
        # reads row-major matrices
        dct = torch.from_numpy(_dct_matrix()).to(device).contiguous()
        idct = torch.from_numpy(_idct_matrix_np()).to(device).contiguous()
        m = (dct, idct, dct.t().contiguous())
        _matrices_on[key] = m
    return m


def _scaled(blocks: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """y = (blocks DCT^T) / qtab, (B, N, 64)."""
    dct = dct_matrices(blocks.device)[0]
    return torch.einsum("uk,bnk->bnu", dct, blocks) / qtabs[:, None, :]


def jpeg_block_transform_reference(blocks: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """Kernel #15's spec in fp32 (differentiable)."""
    idct = dct_matrices(blocks.device)[1]
    y = _scaled(blocks, qtabs)
    r = torch.round(y)
    return torch.einsum("uk,bnu->bnk", idct, (r + (y - r) ** 3) * qtabs[:, None, :])


def ties(blocks: torch.Tensor, qtabs: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """(B, N, 64) bool: the quantised coefficients y of the input that lie
    within `tol` of a half-integer, where two summation orders may round
    apart."""
    y = _scaled(blocks.float(), qtabs.float())
    return (y - torch.floor(y) - 0.5).abs() < tol


def jpeg_block_transform(blocks: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """blocks (B, N, 64) fp32, qtabs (B, 64) fp32 -> (B, N, 64), as
    `jpeg_block_transform_reference` computes it. On a CUDA tensor it
    launches `csrc/jpeg_block.cu` once; on a CPU tensor it runs the plain
    version."""
    if blocks.device.type == "cpu":
        return jpeg_block_transform_reference(blocks, qtabs)
    b, n = blocks.shape[0], blocks.shape[1]
    _check_cuda("blocks", blocks, (b, n, 64), blocks.device)
    _check_cuda("qtabs", qtabs, (b, 64), blocks.device)
    if torch.is_grad_enabled() and (blocks.requires_grad or qtabs.requires_grad):
        raise RuntimeError(
            "jpeg_block_transform: the CUDA kernel has no backward (neither has the JAX "
            "one), so it would cut the gradient; call it under torch.no_grad()"
        )
    if b * n * 64 >= 2**31:
        raise ValueError(f"jpeg_block_transform: {b * n} blocks are more than the kernel indexes")
    if blocks.data_ptr() % 16:
        raise ValueError("jpeg_block_transform: blocks must be 16-byte aligned")
    out = torch.empty_like(blocks)
    if out.numel() == 0:
        return out
    _, idct, dct_t = dct_matrices(blocks.device)
    jpeg_block_transform.launches += 1
    _launch(LIB, "trr_jpeg_block", blocks.device, blocks.data_ptr(), qtabs.data_ptr(),
            dct_t.data_ptr(), idct.data_ptr(), out.data_ptr(), b * n, n)
    return out


jpeg_block_transform.launches = 0
