"""Why the training backwards' products split each operand (3xTF32).

The engine of `trainner_redux_tpu_torch/csrc/tc_gemm.cuh` runs every
per-token product of #5, #6, #7, #10 and #12 on the tensor cores, and #6's
window attention runs its six products on mma.sync; both read TF32 (10
mantissa bits). Each fp32 operand x is split into hi = rna_tf32(x) and lo =
rna_tf32(x - hi), and a product accumulates lo*hi + hi*lo + hi*hi in fp32,
one k-step of 8 at a time. This file emulates that arithmetic on the CPU,
bit for bit in its rounding of the operands, at the kernels' product shapes
(small T), and holds it within 1e-5 of a float64 product relative to the
largest entry of the output; plain 1xTF32 (hi*hi alone) must miss by at
least 20 times as much, which is why the split is there. The attention
backward of one window and head (#6's n 144 in row blocks of 48 and n 64 in
one block; #8's n 256 in row blocks of 64 and n 128 in row blocks of 32,
four warps a row tile, each over a quarter of the keys; head dim 30
zero-padded to 32; the key parts' row sums added in the kernel's order)
keeps each of its outputs within 1e-4 of the float64 result's largest
entry; 1xTF32 misses that limit. The post-norm MLP backward (#14) in the order of its stages on the
engine, at a 128-token tile of Swin2SR-M's and Swin2SR-L's widths, keeps
each gradient within 1e-4 of the float64 result's largest entry. The
pre-LN block forwards (#1, #2, #4, #9 at 8x8; csrc/block_fwd.cuh) in the
order of their stages, with the per-token products promoted as the kernels
take them (each 32-deep slice's sum carried alone, then added to the
accumulator in fp32): the window-attention forward's P and att, qkv and the
residual products at C 180, the MLP half at C 180 / 360 and C 240 / 480 on
a 128-token tile, each within 1e-4 of the float64 result's largest entry,
which 1xTF32 misses. Swin2SR's post-norm forwards (#11, #13) the same way:
the cosine window attention at n 64 with q and k normalised per row and
the temperature at its largest, 100 (P and att), and the halves' products
followed by the post-norm row pass (z at C 180 / 360 and C 240 / 480).
The saved-P form of the attention backward (#10 at n 144 and 64), from the
float64 softmax cast to fp32, the last four products: dq, dk, dv and dS
within 1e-4 of float64. DiffJPEG's block transform (#15): the DCT's sums
and the output within 1e-5 of float64, blocks near a rounding tie left
out.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

C, HIDDEN, C_SRF, HIDDEN_SRF, T = 180, 360, 240, 480, 128
K_STEP = 8  # the depth of one mma.sync.m16n8k8


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 bits cleared: a TF32 value, rounded toward zero."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_trunc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The mma.sync helpers' split (tc_gemm.cuh): hi and lo by truncation."""
    hi = trunc_tf32(x)
    return hi, trunc_tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int, split=split) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the kernels sum it: an fp32 accumulator that
    takes, for every k-step of 8 in order, lo*hi, hi*lo, then hi*hi (terms
    3), or hi*hi alone (terms 1), each operand split by `split`."""
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


def promoted(a: torch.Tensor, b: torch.Tensor, terms: int, chunk: int = 32) -> torch.Tensor:
    """`product` as the forwards' per-token kernels sum it (tc_rows.cuh's
    xw_product, two 16-deep chunks a promotion): each chunk-deep slice of
    the depth summed alone, then added to the accumulator in fp32."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], chunk):
        acc = acc + product(a[:, k:k + chunk], b[k:k + chunk], terms)
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
    hi + lo is x to within 2^-21 of |x| (2^-20 by truncation)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    gap = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((gap <= 2.0**-21 * x.double().abs()).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert rna_tf32(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
    # the truncating split of the mma.sync helpers: TF32 halves, hi + lo
    # within 2^-20 of |x|
    hi, lo = split_trunc(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    gap = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((gap <= 2.0**-20 * x.double().abs()).all())


HD, HD_PAD = 30, 32  # a head's channels, padded to the kernel's 32


def _softmax_parts(s: torch.Tensor, ks: int) -> torch.Tensor:
    """The row softmax as the kernel takes it: the row max, then each of the
    ks key parts' sum of exp, the parts added in order."""
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    return e / _sum_parts(e, ks)


def _sum_parts(e: torch.Tensor, ks: int) -> torch.Tensor:
    """Row sums of e, each of the ks key parts summed alone, added in part
    order."""
    parts = e.chunk(ks, dim=-1)
    total = parts[0].sum(-1, keepdim=True)
    for part in parts[1:]:
        total = total + part.sum(-1, keepdim=True)
    return total


@functools.lru_cache(maxsize=None)
def _attention_case(n: int, rb: int):
    """One window and head: seeded q, k, v, datt (n, 30) and an (n, n) bias."""
    rng = np.random.default_rng(n)
    q, k, v, da = (rng.standard_normal((n, HD)).astype(np.float32) for _ in range(4))
    table = (rng.standard_normal((n, n)) * 0.5).astype(np.float32)
    return q, k, v, da, table


def _attention_exact(n: int, rb: int) -> dict:
    q, k, v, da, table = (torch.from_numpy(a).double() for a in _attention_case(n, rb))
    scale = HD**-0.5
    p = torch.softmax(q @ k.T * scale + table, -1)
    dp = da @ v.T
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return {"P": p, "att": p @ v, "dq": scale * ds @ k, "dk": scale * ds.T @ q, "dv": p.T @ da,
            "dS": ds}


@functools.lru_cache(maxsize=None)
def _attention_kernel(n: int, rb: int, terms: int, ks: int = 2, saved: bool = False) -> dict:
    """The window attention's backward as attn_rows_bwd_tc_kernel takes it:
    the query rows in blocks of rb, ks warps a 16-row tile each over a part
    of the keys, the six products through `product` with the truncating
    split on the zero-padded rows (S = q k^T, att = P v (#6 only), dV +=
    P^T dA, dP = dA v^T, dQ = scale dS k, dK += dS^T q, dK scaled at the
    end), the softmax and dS in fp32, the parts' row sums and rowsum(P dP)
    added in part order. `saved`, its saved-P form (#10): each row block's
    P read from the float64 softmax cast to fp32 (the forward's, to within
    its rounding), no S and no softmax: the last four products."""
    q, k, v, da = (torch.nn.functional.pad(torch.from_numpy(a), (0, HD_PAD - HD))
                   for a in _attention_case(n, rb)[:4])
    table = torch.from_numpy(_attention_case(n, rb)[4])
    scale = HD**-0.5
    p_saved = _attention_exact(n, rb)["P"].float()
    ps, att, dq, dss = [], [], [], []
    dv, dk = torch.zeros(n, HD_PAD), torch.zeros(n, HD_PAD)
    mm = functools.partial(product, terms=terms, split=split_trunc)
    for r0 in range(0, n, rb):
        rows = slice(r0, r0 + rb)
        if saved:
            p = p_saved[rows]
        else:
            p = _softmax_parts(mm(q[rows], k.T.contiguous()) * scale + table[rows], ks)
        ps.append(p)
        att.append(mm(p, v))
        dv = dv + mm(p.T.contiguous(), da[rows])
        dp = mm(da[rows], v.T.contiguous())
        ds = p * (dp - _sum_parts(p * dp, ks))
        dss.append(ds)
        dq.append(scale * mm(ds, k))
        dk = dk + mm(ds.T.contiguous(), q[rows])
    return {"P": torch.cat(ps), "att": torch.cat(att)[:, :HD], "dq": torch.cat(dq)[:, :HD],
            "dk": scale * dk[:, :HD], "dv": dv[:, :HD], "dS": torch.cat(dss)}


def _attention_error(n: int, rb: int, terms: int, name: str, ks: int = 2,
                     saved: bool = False) -> float:
    want = _attention_exact(n, rb)[name]
    got = _attention_kernel(n, rb, terms, ks, saved)[name].double()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name", ["att", "dq", "dk", "dv", "dS"])
@pytest.mark.parametrize(("n", "rb", "ks"), [(144, 48, 2), (64, 64, 2), (256, 64, 4),
                                             (128, 32, 4)],
                         ids=["n144", "n64", "n256", "n128"])
def test_attention_backward_in_3xtf32_holds_the_gradient_limit(n, rb, ks, name):
    """The window attention on mma.sync (#6's and #8's; #12's is the same at
    n 64; #8 computes no att): each output within 1e-4 of its largest entry
    against float64 in 3xTF32; 1xTF32 misses the limit."""
    err3 = _attention_error(n, rb, 3, name, ks)
    err1 = _attention_error(n, rb, 1, name, ks)
    assert err3 <= 1e-4, err3
    assert err1 > 1e-4, err1
    assert err1 >= 20 * err3, (err1, err3)


@pytest.mark.parametrize("name", ["dq", "dk", "dv", "dS"])
@pytest.mark.parametrize(("n", "rb", "ks"), [(144, 48, 2), (64, 64, 2)], ids=["n144", "n64"])
def test_saved_p_attention_backward_in_3xtf32_holds_the_gradient_limit(n, rb, ks, name):
    """The saved-P form of the window attention on mma.sync (#10 at 12x12
    and 8x8 windows): from the forward's P, dV, dP, dQ and dK in the
    kernel's row blocks, key parts and truncating split, each output within
    1e-4 of its largest entry against float64 in 3xTF32; 1xTF32 misses the
    limit."""
    err3 = _attention_error(n, rb, 3, name, ks, saved=True)
    err1 = _attention_error(n, rb, 1, name, ks, saved=True)
    assert err3 <= 1e-4, err3
    assert err1 > 1e-4, err1
    assert err1 >= 20 * err3, (err1, err3)


@pytest.mark.parametrize("name", ["P", "att"])
@pytest.mark.parametrize(("n", "rb", "ks"), [(64, 64, 2), (144, 48, 2), (256, 64, 4),
                                             (128, 32, 4)],
                         ids=["n64", "n144", "n256", "n128"])
def test_attention_forward_in_3xtf32_holds_the_limit(n, rb, ks, name):
    """The window-attention forward on mma.sync (attn_rows_fwd_tc_kernel:
    #1, #4 and #9 at 8x8 windows, #1 and #9 at 12x12 (n 144), #3 at every
    window: n 64, 128 and 256), S = q k^T and att = P v in the backward's
    row blocks, key parts and truncating split, the sums of P v 144 and 256
    deep unpromoted: P and att within 1e-4 of their largest entry against
    float64; 1xTF32 misses the limit."""
    err3 = _attention_error(n, rb, 3, name, ks)
    err1 = _attention_error(n, rb, 1, name, ks)
    assert err3 <= 1e-4, err3
    assert err1 > 1e-4, err1


def _gelu(h):
    return 0.5 * h * (1.0 + torch.special.erf(h * 0.5**0.5))


def _gelu_grad(h):
    return 0.5 * (1.0 + torch.special.erf(h * 0.5**0.5)) + h * torch.exp(-0.5 * h * h) * (
        2 * torch.pi) ** -0.5


@functools.lru_cache(maxsize=None)
def _mlp_case(c: int, hidden: int):
    """A 128-token tile of the post-norm MLP half: seeded x, dout (T, C), its
    weights, a DropPath scale of 1/0.9."""
    rng = np.random.default_rng(c + hidden)
    x, dout = (rng.standard_normal((T, c)).astype(np.float32) for _ in range(2))
    w1 = (rng.standard_normal((c, hidden)) * c**-0.5).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c)) * hidden**-0.5).astype(np.float32)
    b1, b2, be = ((rng.standard_normal(k) * 0.1).astype(np.float32) for k in (hidden, c, c))
    g = (1.0 + rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, dout, w1, b1, w2, b2, g, be


def _mlp_backward(c: int, hidden: int, mm) -> dict:
    """#14's gradients with its products through `mm`, in its stages' order:
    hg = gelu(x w1 + b1), m = hg w2 + b2, dm = LN'(s dout) from m's stats,
    h again, dh = (dm w2^T) gelu'(h), dx = dout + dh w1^T, dw2 = hg^T dm,
    dw1 = x^T dh, the biases', dg's and dbe's sums over the tokens."""
    x, dout, w1, b1, w2, b2, g, be = (torch.from_numpy(a) for a in _mlp_case(c, hidden))
    if mm is None:  # float64, the products exact
        x, dout, w1, b1, w2, b2, g = (t.double() for t in (x, dout, w1, b1, w2, b2, g))

        def mm(a, b):
            return a @ b
    sc, eps = 1.0 / 0.9, 1e-5
    h = mm(x, w1) + b1
    hg = _gelu(h)
    m = mm(hg, w2) + b2
    mean = m.mean(-1, keepdim=True)
    inv = 1.0 / torch.sqrt(((m - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (m - mean) * inv
    dy = sc * dout
    e = dy * g
    dm = inv * (e - e.mean(-1, keepdim=True) - xn * (e * xn).mean(-1, keepdim=True))
    dh = mm(dm, w2.T.contiguous()) * _gelu_grad(h)
    return {"dx": dout + mm(dh, w1.T.contiguous()), "dw1": mm(x.T.contiguous(), dh),
            "db1": dh.sum(0), "dw2": mm(hg.T.contiguous(), dm), "db2": dm.sum(0),
            "dg": (dy * xn).sum(0), "dbe": dy.sum(0)}


@pytest.mark.parametrize("name", ["dx", "dw1", "db1", "dw2", "db2", "dg", "dbe"])
@pytest.mark.parametrize(("c", "hidden"), [(C, HIDDEN), (C_SRF, HIDDEN_SRF)],
                         ids=["c180", "c240"])
def test_postnorm_mlp_backward_in_3xtf32_holds_the_gradient_limit(c, hidden, name):
    """#14 on the engine (every product in 3xTF32, round-to-nearest splits):
    each gradient within 1e-4 of its largest entry against float64, at
    Swin2SR-M's and Swin2SR-L's widths; through a product 1xTF32 strays
    further than 3xTF32 does."""
    want = _mlp_backward(c, hidden, None)[name]
    errs = []
    for terms in (3, 1):
        got = _mlp_backward(c, hidden, functools.partial(product, terms=terms))[name]
        errs.append(((got.double() - want).abs().max() / want.abs().max()).item())
    assert errs[0] <= 1e-4, errs
    if name != "dbe":  # dbe = sum s dout takes no product
        assert errs[1] > errs[0], errs


@functools.lru_cache(maxsize=None)
def _block_case(c: int, hidden: int):
    """A 128-token tile of a pre-LN Swin block at C / hidden: seeded x,
    att (T, C), LN affine, qkv, proj, fc1 and fc2 weights (unit-scale
    inputs, weights at 1/sqrt(fan-in)), the DropPath scale of a kept
    sample, 1/0.9."""
    rng = np.random.default_rng(10 * c + hidden)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "x": normal(T, c), "att": normal(T, c), "g": 1.0 + normal(c, scale=0.1),
        "be": normal(c, scale=0.1), "wq": normal(c, 3 * c, scale=c**-0.5),
        "bq": normal(3 * c, scale=0.1), "wp": normal(c, c, scale=c**-0.5),
        "bp": normal(c, scale=0.1), "w1": normal(c, hidden, scale=c**-0.5),
        "b1": normal(hidden, scale=0.1), "w2": normal(hidden, c, scale=hidden**-0.5),
        "b2": normal(c, scale=0.1),
    }


def _block_forward(c: int, hidden: int, mm) -> dict:
    """The forwards' per-token stages at C / hidden with their products
    through `mm` (None: float64, exact): y = LN(x) (two-pass), qkv = y wq +
    bq, z = x + s (att wp + bp) (the attention half's residual product), and
    the MLP half out = x + s (gelu(y w1 + b1) w2 + b2)."""
    t = {k: torch.from_numpy(v) for k, v in _block_case(c, hidden).items()}
    if mm is None:
        t = {k: v.double() for k, v in t.items()}

        def mm(a, b):
            return a @ b
    x, sc = t["x"], 1.0 / 0.9
    mean = x.mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-5) * t["g"] + t["be"]
    h = _gelu(mm(y, t["w1"]) + t["b1"])
    return {"qkv": mm(y, t["wq"]) + t["bq"], "z": x + sc * (mm(t["att"], t["wp"]) + t["bp"]),
            "out": x + sc * (mm(h, t["w2"]) + t["b2"])}


@pytest.mark.parametrize(("c", "hidden", "name"), [(C, HIDDEN, "qkv"), (C, HIDDEN, "z"),
                                                   (C, HIDDEN, "out"),
                                                   (C_SRF, HIDDEN_SRF, "out")],
                         ids=["qkv-c180", "proj-residual-c180", "mlp-c180", "mlp-c240"])
def test_block_forward_stages_in_3xtf32_hold_the_limit(c, hidden, name):
    """The per-token stages of the pre-LN forwards on the engine, each
    product promoted chunk by chunk as the kernels sum it: qkv (linear_kernel)
    and the residual products (its residual epilogue) at C 180, and the MLP half
    (LN, fc1 + gelu, fc2 + residual) at C 180 / 360 and at C 240 / 480,
    within 1e-4 of the float64 result's largest entry; 1xTF32 misses."""
    want = _block_forward(c, hidden, None)[name]
    errs = []
    for terms in (3, 1):
        got = _block_forward(c, hidden, functools.partial(promoted, terms=terms))[name]
        errs.append(((got.double() - want).abs().max() / want.abs().max()).item())
    assert errs[0] <= 1e-4, errs
    assert errs[1] > 1e-4, errs


TEMP_MAX = 100.0  # the cosine attention's largest temperature, exp(log 100)
N_COS = 64  # tokens of an 8x8 window


@functools.lru_cache(maxsize=None)
def _cos_case():
    """One 8x8 window and head of SwinV2's cosine attention: seeded q, k, v
    (64, 30) before the normalisation and a (64, 64) table of 16 * sigmoid
    values, as Swin2SR's CPB MLP gives it."""
    rng = np.random.default_rng(64)
    q, k, v = (rng.standard_normal((N_COS, HD)).astype(np.float32) for _ in range(3))
    table = (16.0 / (1.0 + np.exp(-rng.standard_normal((N_COS, N_COS))))).astype(np.float32)
    return q, k, v, table


def _normalize_rows(t: torch.Tensor) -> torch.Tensor:
    """Each row divided by max(|row|, 1e-12), as the staging of q and k
    takes it (tc_attn.cuh, stage_head_rows' NORM): a channel a lane, the
    squares summed by a butterfly over the 32 lanes of a warp, one inverse,
    a product a channel."""
    sq = torch.nn.functional.pad(t * t, (0, HD_PAD - t.shape[1]))
    for o in (16, 8, 4, 2, 1):
        sq = sq + sq[:, torch.arange(HD_PAD) ^ o]
    return t * (1.0 / torch.sqrt(sq[:, 0]).clamp_min(1e-12))[:, None]


def _cos_attention(terms: int | None) -> dict:
    """The cosine window-attention forward at TEMP_MAX: float64 and exact
    (terms None), or as attn_rows_fwd_tc_kernel's cosine form takes it on
    the (64, 64, 2) plan: q^ and k^ in fp32, S = q^ k^T and att = P v
    through `product` with the truncating split on the zero-padded rows, the
    softmax's two key halves added in order."""
    q, k, v, table = (torch.from_numpy(a) for a in _cos_case())
    if terms is None:
        q, k, v, table = (t.double() for t in (q, k, v, table))
        qn, kn = _normalize_rows(q), _normalize_rows(k)
        p = torch.softmax(qn @ kn.T * TEMP_MAX + table, -1)
        return {"P": p, "att": p @ v}
    qn, kn, v = (torch.nn.functional.pad(t, (0, HD_PAD - HD))
                 for t in (_normalize_rows(q), _normalize_rows(k), v))
    mm = functools.partial(product, terms=terms, split=split_trunc)
    p = _softmax_parts(mm(qn, kn.T.contiguous()) * TEMP_MAX + table, 2)
    return {"P": p, "att": mm(p, v)[:, :HD]}


@pytest.mark.parametrize("name", ["P", "att"])
def test_cosine_attention_forward_in_3xtf32_holds_the_limit(name):
    """#11's window attention (and #12's forward stage) on mma.sync, the
    cosine form at n 64 on the (64, 64, 2) plan, q and k normalised per row
    and the temperature at its largest, 100, which multiplies the error of
    cos = q^ k^T before the softmax: P and att within 1e-4 of their largest
    entry against float64; 1xTF32 misses the limit."""
    want = _cos_attention(None)[name]
    errs = [((_cos_attention(terms)[name].double() - want).abs().max()
             / want.abs().max()).item() for terms in (3, 1)]
    assert errs[0] <= 1e-4, errs
    assert errs[1] > 1e-4, errs


def _postnorm_forward(c: int, hidden: int, mm) -> dict:
    """The post-norm halves' forward stages at C / hidden with their
    products through `mm` (None: float64, exact), then the post-norm row
    pass (a two-pass LayerNorm, the residual): #11's z = x + s LN1(att wp
    + bp) from its attention output, #13's out = x + s LN2(gelu(x w1 + b1)
    w2 + b2)."""
    t = {k: torch.from_numpy(v) for k, v in _block_case(c, hidden).items()}
    if mm is None:
        t = {k: v.double() for k, v in t.items()}

        def mm(a, b):
            return a @ b
    x, sc = t["x"], 1.0 / 0.9

    def post_norm(m):
        mean = m.mean(-1, keepdim=True)
        inv = 1.0 / torch.sqrt(((m - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
        return x + sc * ((m - mean) * inv * t["g"] + t["be"])

    hg = _gelu(mm(x, t["w1"]) + t["b1"])
    return {"z": post_norm(mm(t["att"], t["wp"]) + t["bp"]),
            "out": post_norm(mm(hg, t["w2"]) + t["b2"])}


@pytest.mark.parametrize(("c", "hidden", "name"), [(C, HIDDEN, "z"), (C, HIDDEN, "out"),
                                                   (C_SRF, HIDDEN_SRF, "out")],
                         ids=["attention-c180", "mlp-c180", "mlp-c240"])
def test_postnorm_forward_stages_in_3xtf32_hold_the_limit(c, hidden, name):
    """The post-norm halves' forwards (#11's proj and row pass, #13's fc1 +
    gelu, fc2 and row pass) in the order of their stages, each product
    promoted chunk by chunk as linear_kernel sums it, at Swin2SR-M's C 180
    / hidden 360 and Swin2SR-L's C 240 / hidden 480: within 1e-4 of the
    float64 result's largest entry; 1xTF32 misses."""
    want = _postnorm_forward(c, hidden, None)[name]
    errs = []
    for terms in (3, 1):
        got = _postnorm_forward(c, hidden, functools.partial(promoted, terms=terms))[name]
        errs.append(((got.double() - want).abs().max() / want.abs().max()).item())
    assert errs[0] <= 1e-4, errs
    assert errs[1] > 1e-4, errs


@functools.lru_cache(maxsize=None)
def _jpeg_case(table_name: str) -> dict:
    """DiffJPEG's block transform (#15) on 4 samples of 64 seeded blocks
    (level-shifted values, each block about its own mean) with the Y or C
    table at qualities 45-95: the DCT's sums c and the output in float64,
    and as jpeg_tc_kernel takes them in 3xTF32 and 1xTF32 (both 64-deep
    products through `product` with the truncating split, k-steps 0-3 and
    4-7 summed apart and then added; the quantisation in fp32). Blocks with
    a coefficient within 1e-4 of a rounding tie in float64 are marked."""
    from trainner_redux_tpu_torch.utils import diffjpeg as dj

    rng = np.random.default_rng(15)
    b, nb = 4, 64
    blocks = (rng.random((b, nb, 64)) * 60 - 30 + rng.random((b, nb, 1)) * 180 - 90)
    table = dj.Y_TABLE if table_name == "Y" else dj.C_TABLE
    factor = dj.quality_to_factor(torch.linspace(45, 95, b)).numpy()[:, None]
    qtabs = np.clip(table.reshape(1, 64) * factor, 1, 255).astype(np.float32)
    x = torch.from_numpy(blocks.astype(np.float32)).reshape(-1, 64)
    qt = torch.from_numpy(qtabs).repeat_interleave(nb, 0)
    dct, idct = torch.from_numpy(dj._dct_matrix()), torch.from_numpy(dj._idct_matrix_np())
    c = x.double() @ dct.double().T
    y = c / qt.double()
    r = torch.round(y)
    out = {"exact": {"c": c, "out": ((r + (y - r) ** 3) * qt.double()) @ idct.double()},
           "tied": ((y - torch.floor(y) - 0.5).abs() < 1e-4).any(-1)}
    def halves(a, b, terms):
        return (product(a[:, :32], b[:32], terms, split_trunc)
                + product(a[:, 32:], b[32:], terms, split_trunc))

    for terms in (3, 1):
        c = halves(x, dct.T.contiguous(), terms)
        y = c / qt
        r = torch.round(y)
        d = y - r
        out[terms] = {"c": c, "out": halves((r + d * d * d) * qt, idct, terms)}
    return out


@pytest.mark.parametrize("name", ["c", "out"])
@pytest.mark.parametrize("table", ["Y", "C"])
def test_jpeg_block_transform_in_3xtf32_holds_the_limit(table, name):
    """#15's two products on mma.sync (jpeg_tc_kernel): the DCT's sums and
    the output, blocks near a rounding tie left out, within 1e-5 of their
    largest entry against float64 in 3xTF32 (the output within 1e-3
    absolute, chip_smoke.py's JPEG_TOL, by far); 1xTF32 misses the limit."""
    case = _jpeg_case(table)
    keep = ~case["tied"]
    assert int(keep.sum()) >= 250
    want = case["exact"][name][keep]
    top = want.abs().max().item()
    err3, err1 = ((case[t][name][keep].double() - want).abs().max().item() for t in (3, 1))
    assert err3 <= 1e-5 * top, (err3, top)
    assert err1 > 1e-5 * top, (err1, top)
    assert err1 >= 20 * err3, (err1, err3)
    if name == "out":
        assert err3 <= 1e-3
