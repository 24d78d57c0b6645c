"""Why the training backwards' products split each operand (3xTF32).

The engine of `trainner_redux_tpu_torch/csrc/tc_gemm.cuh` runs every
product of #5 and #7 on the tensor cores, which read TF32 (10 mantissa
bits). It splits each fp32 operand x into hi = rna_tf32(x) and lo =
rna_tf32(x - hi) and accumulates lo*hi + hi*lo + hi*hi in fp32, one
mma.sync k-step of 8 at a time. This file emulates that arithmetic on the
CPU, bit for bit in its rounding of the operands, at the kernels' product
shapes (small T), and holds it within 1e-5 of a float64 product relative to
the largest entry of the output; plain 1xTF32 (hi*hi alone) must miss by at
least 20 times as much, which is why the split is there.
"""

import numpy as np
import pytest
import torch

C, HIDDEN, C_SRF, HIDDEN_SRF, T = 180, 360, 240, 480, 128
K_STEP = 8  # the depth of one mma.sync.m16n8k8


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the kernels sum it: an fp32 accumulator that
    takes, for every k-step of 8 in order, lo*hi, hi*lo, then hi*hi (terms
    3), or hi*hi alone (terms 1)."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], K_STEP):
        ks = slice(k, k + K_STEP)
        if terms == 3:
            acc = acc + al[:, ks] @ bh[ks]
            acc = acc + ah[:, ks] @ bl[ks]
        acc = acc + ah[:, ks] @ bh[ks]
    return acc


# (name, rows, depth, columns, scale of the right operand): each product of
# #5 and #7 at a few tokens; the weight gradients take the tokens as depth.
PRODUCTS = [
    ("h = y2 w1 (#5, #7)", T, C, HIDDEN, C**-0.5),
    ("dh = dm w2^T (#5, #7)", T, C, HIDDEN, HIDDEN**-0.5),
    ("dy2 = dh w1^T (#5, #7)", T, HIDDEN, C, C**-0.5),
    ("datt = dzp wp^T (#5)", T, C, C, C**-0.5),
    ("dy = dqkv wq^T (#5)", T, 3 * C, C, C**-0.5),
    ("dy = dh w1^T at C 240 (#7)", T, HIDDEN_SRF, C_SRF, C_SRF**-0.5),
    ("dwq = y^T dqkv", C, 4 * T, 3 * C, 1.0),
    ("dw2 = hg^T dm", HIDDEN, 4 * T, C, 1.0),
]


@pytest.mark.parametrize(("rows", "depth", "cols", "scale"), [p[1:] for p in PRODUCTS],
                         ids=[p[0] for p in PRODUCTS])
def test_3xtf32_holds_fp32_accuracy_where_1xtf32_does_not(rows, depth, cols, scale):
    rng = np.random.default_rng(rows * 1000 + depth + cols)
    a = rng.standard_normal((rows, depth)).astype(np.float32)
    b = (rng.standard_normal((depth, cols)) * scale).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    top = np.abs(exact).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(product(ta, tb, 3).double().numpy() - exact).max() / top
    err1 = np.abs(product(ta, tb, 1).double().numpy() - exact).max() / top
    assert err3 <= 1e-5, err3
    assert err1 >= 20 * err3, (err1, err3)


def test_the_split_is_exact_in_tf32():
    """hi and lo carry 10 mantissa bits each (their low 13 bits are 0), and
    hi + lo is x to within 2^-21 of |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    gap = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((gap <= 2.0**-21 * x.double().abs()).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert rna_tf32(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
