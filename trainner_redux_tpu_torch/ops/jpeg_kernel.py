"""The fused JPEG block transform (TPU kernel #15): the CUDA kernel's
wrappers and its plain PyTorch version.

Port of the JAX package's ops/pallas/jpeg_kernel.py. Per flattened 8x8
block of blocks (B, N, 64), level-shifted spatial values in [-128, 127],
with the per-sample quantisation table qtabs (B, 64):

    c = x DCT^T;  y = c / qtab;  r = round(y);  q = r + (y - r)^3;
    out = (q * qtab) IDCT

(`utils/diffjpeg.py`'s `_dct_matrix` and `_idct_matrix_np`, (64, 64) each;
round to nearest, halves to even). DiffJPEG's `encode_decode` calls
`jpeg_block_transform_planes` once a compression, on its three planes: Y,
Cb and Cr.

On a CUDA tensor `jpeg_block_transform` (one plane, the JAX function's
counterpart) and `jpeg_block_transform_planes` (up to three) launch
`csrc/jpeg_block.cu` once; on a CPU tensor they run
`jpeg_block_transform_reference`, two einsums around the quantisation, as
the JAX package's `diff_jpeg` writes them, per plane. Anything else raises.
`jpeg_block_transform.launches` counts the kernel's launches by either.
The kernel is forward only, as the JAX one is (no VJP): on the card the
wrappers refuse inputs that require a gradient. The CPU version stays
differentiable.

The differentiable round jumps at half-integers: r + (y - r)^3 is r + 1/8
just below r + 1/2 and r + 1 - 1/8 just above, so a coefficient within
rounding of a tie moves by 3/4 qtab between two summation orders.
`ties` marks such coefficients of an input.
"""

from __future__ import annotations

import torch

from trainner_redux_tpu_torch.ops.fused_block import _check_aligned, _launch
from trainner_redux_tpu_torch.ops.window_attention import _check_cuda

LIB = "jpeg_block"
PLANES = 3  # the most a launch takes (kJpegPlanes)

_matrices_on: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def split_trunc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x as TF32 hi + lo, each by truncation (its low 13 bits cleared),
    as the mma.sync helpers of csrc/tc_gemm.cuh split an operand."""
    hi = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def b_fragments(m: torch.Tensor) -> torch.Tensor:
    """The B operand B(k, n) = m[n, k] of a 64-deep mma.sync m16n8k8 product
    in its fragment order, split: (8 k-steps, 8 n-tiles, 32 lanes, 4), lane
    4 g + q holding (hi b0, hi b1, lo b0, lo b1) with b0 = B(8 ks + q, 8 nt +
    g) and b1 = B(8 ks + q + 4, 8 nt + g)."""
    # m[8 nt + g, 8 ks + 4 half + q] -> [ks, nt, g, q, half]
    b = m.reshape(8, 8, 8, 2, 4).permute(2, 0, 1, 4, 3).reshape(8, 8, 32, 2)
    hi, lo = split_trunc(b)
    return torch.cat([hi, lo], dim=-1).contiguous()


def dct_matrices(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(DCT, IDCT), (64, 64) fp32 each, row-major, and the kernel's split B
    fragments of both products (2, 8, 8, 32, 4): the DCT's (B(k, u) =
    DCT[u, k]) and the IDCT's (B(u, k) = IDCT[u, k]); on `device` (made
    there once)."""
    from trainner_redux_tpu_torch.utils.diffjpeg import _dct_matrix, _idct_matrix_np

    key = str(torch.device(device))
    m = _matrices_on.get(key)
    if m is None:
        # _idct_matrix_np() is a transpose, column-major in numpy
        dct = torch.from_numpy(_dct_matrix()).contiguous()
        idct = torch.from_numpy(_idct_matrix_np()).contiguous()
        frags = torch.stack([b_fragments(dct), b_fragments(idct.t())])
        m = tuple(t.to(device) for t in (dct, idct, frags))
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


def jpeg_block_transform_planes(
    planes: list[tuple[torch.Tensor, torch.Tensor]],
) -> list[torch.Tensor]:
    """Up to three planes (blocks (B, N_i, 64), qtabs (B, 64)) -> their
    outputs (B, N_i, 64), each as `jpeg_block_transform_reference` computes
    it. On CUDA tensors it launches `csrc/jpeg_block.cu` once for all of
    them; on CPU tensors it runs the plain version on each."""
    if not 1 <= len(planes) <= PLANES:
        raise ValueError(f"jpeg_block_transform_planes: takes 1 to {PLANES} planes, "
                         f"got {len(planes)}")
    if all(blocks.device.type == "cpu" for blocks, _ in planes):
        return [jpeg_block_transform_reference(blocks, qtabs) for blocks, qtabs in planes]
    name = "jpeg_block_transform"
    device = planes[0][0].device
    outs, args = [], []
    for i, (blocks, qtabs) in enumerate(planes):
        b, n = blocks.shape[0], blocks.shape[1]
        _check_cuda(f"blocks[{i}]", blocks, (b, n, 64), device)
        _check_cuda(f"qtabs[{i}]", qtabs, (b, 64), device)
        if torch.is_grad_enabled() and (blocks.requires_grad or qtabs.requires_grad):
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward (neither has the JAX one), so it "
                "would cut the gradient; call it under torch.no_grad()"
            )
        if b * n * 64 >= 2**31:
            raise ValueError(f"{name}: {b * n} blocks are more than the kernel indexes")
        out = torch.empty_like(blocks)
        _check_aligned(name, **{f"blocks[{i}]": blocks, f"out[{i}]": out})
        outs.append(out)
        args += [blocks.data_ptr(), qtabs.data_ptr(), out.data_ptr(), b * n, max(n, 1)]
    args += [0, 0, 0, 0, 1] * (PLANES - len(planes))
    if all(out.numel() == 0 for out in outs):
        return outs
    frags = dct_matrices(device)[2]
    jpeg_block_transform.launches += 1
    _launch(LIB, "trr_jpeg_planes", device, frags.data_ptr(), len(planes), *args)
    return outs


def jpeg_block_transform(blocks: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """blocks (B, N, 64) fp32, qtabs (B, 64) fp32 -> (B, N, 64), as
    `jpeg_block_transform_reference` computes it. On a CUDA tensor it
    launches `csrc/jpeg_block.cu` once; on a CPU tensor it runs the plain
    version."""
    if blocks.device.type == "cpu":
        return jpeg_block_transform_reference(blocks, qtabs)
    return jpeg_block_transform_planes([(blocks, qtabs)])[0]


jpeg_block_transform.launches = 0


def empty_launch(device) -> None:
    """Launch an empty kernel of one warp on `device`: the launch floor that
    #15's times at the OTF path's planes are read against."""
    _launch(LIB, "trr_empty_launch", device)
