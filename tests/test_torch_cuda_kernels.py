"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks its fixture for a card and skips without
one (here on the CPU they skip). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

Shapes are SwinIR-M's (C=180, 6 heads of 30, window 8, hidden 360) at a
64x96 map and batch 2, HAT-M's 16x16 windows at the same widths, and DAT's
rect windows (a 90-channel branch, 3 heads of 30: 8x32, 32x8, 8x16, 16x8)
at batch 2 and a 64x64 map; unit-scale fp32 inputs, tolerance 1e-4 (the
kernels sum in another order than cuBLAS); the training kernels' gradients
within 1e-4 of each tensor's largest magnitude. DiffJPEG's block transform
(#15) at the OTF path's planes and at 8 images of 512x512, within 1e-3 on
spatial values in [-128, 127], blocks near a rounding tie left out, and a
compression's three planes in one launch, bit for bit the single-plane
launches.
SRFormerV2's Swin blocks (C=240, 8 heads of 30, 12x12 windows, hidden 480)
at batch 2 and a 48x72 map: #1 on the tensor-core stages, #6, and #2/#7.
The training form of the attention half (#9 and its saved-P backward #10)
at both: 8x8 windows at SwinIR-M's widths, 12x12 at SRFormerV2's.
The bf16 forms of #4 and #5 (bf16 x, dout, P, att, z; fp32 parameters)
against their bf16 plain versions at SwinIR-M's and SwinIR-S's widths:
outputs within BF16_TOL (1e-2, some 2.5 bf16 steps) of each tensor's
largest magnitude with at most one element in a thousand beyond one bf16
step of it (a kernel and its plain version sum in other orders, and a sum
that lies at a rounding tie rounds one way in one and the other way in the
other), gradients within 1e-2 of each tensor's largest. The same for the
bf16 forms of #3/#8 (HAT-M's 16x16 windows, SwinIR-L's 8x8 at C 240, DAT's
rect windows), of #2/#7 (HAT-M's MLP half) and of #1/#6 (SRFormerV2's Swin
blocks at 12x12 windows, K=1 and K=4 shifted), each twice bit for bit; and
of #11-#14 (Swin2SR's post-norm halves at SwinIR-M's widths, K=1 and K=4
shifted, the MLP half also at Swin2SR-L's C 240 and Swin2SR-S's C 60).
"""

import numpy as np
import pytest
import torch

B, H, W, C, NH, WS, HIDDEN = 2, 64, 96, 180, 6, 8, 360
HD, N = C // NH, WS * WS
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, kinds, seed=0, ws=WS, shape=(B, H, W)):
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)
    b, h, w = shape
    n = ws * ws

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    p = {
        "x": randn(b, h, w, C), "qkv": randn(b, h, w, 3 * C),
        "g": 1.0 + randn(C, scale=0.1), "be": randn(C, scale=0.1),
        "wq": randn(C, 3 * C, scale=C**-0.5), "bq": randn(3 * C, scale=0.1),
        "wp": randn(C, C, scale=C**-0.5), "bp": randn(C, scale=0.1),
        "w1": randn(C, HIDDEN, scale=C**-0.5), "b1": randn(HIDDEN, scale=0.1),
        "w2": randn(HIDDEN, C, scale=HIDDEN**-0.5), "b2": randn(C, scale=0.1),
        "s": torch.tensor([1.0, 0.8], device=device)[:b],
        "g2": 1.0 + randn(C, scale=0.1), "be2": randn(C, scale=0.1),
        "s2": torch.tensor([0.0, 1.0 / 0.9], device=device)[-b:],
    }
    rel = randn(NH, n, n, scale=0.5)
    if kinds == 4:
        rel = rel[None] + torch.from_numpy(shift_mask_kinds(ws, ws // 2)).to(device)[:, None]
    else:
        rel = rel[None]
    p["bias"] = rel.contiguous()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift"), [(1, 0), (4, 0), (4, WS // 2)])
def test_fused_attn_block_kernel(cuda, kinds, shift):
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, kinds)
    args = [p[k] for k in ("x", "g", "be", "wq", "bq", "wp", "bp", "bias", "s")]
    n0 = fb.fused_attn_block.launches
    got = fb.fused_attn_block(*args, NH, HD, WS, shift=shift)
    torch.cuda.synchronize()
    assert fb.fused_attn_block.launches == n0 + 1
    want = fb.fused_attn_block_reference(*args, NH, HD, WS, shift=shift)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_fused_ln_mlp_kernel(cuda):
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    args = [p[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2", "s")]
    n0 = fb.fused_ln_mlp.launches
    got = fb.fused_ln_mlp(*args, WS)
    torch.cuda.synchronize()
    assert fb.fused_ln_mlp.launches == n0 + 1
    want = fb.fused_ln_mlp_reference(*args, WS)
    assert (got - want).abs().max().item() <= TOL
    # a ragged last tile: 3 rows of 8 windows' worth of tokens, not a multiple of 64
    x = torch.randn(1, 8, 12, C, device=cuda)
    got = fb.fused_ln_mlp(x, *args[1:-1], torch.ones(1, device=cuda), WS)
    want = fb.fused_ln_mlp_reference(x, *args[1:-1], torch.ones(1, device=cuda), WS)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [1, 4])
def test_fused_window_mhsa_kernel(cuda, kinds):
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, kinds)
    n0 = wa.fused_window_mhsa.launches
    got = wa.fused_window_mhsa(p["qkv"], p["bias"], NH, HD, WS)
    torch.cuda.synchronize()
    assert wa.fused_window_mhsa.launches == n0 + 1
    want = wa.fused_window_mhsa_reference(p["qkv"], p["bias"], NH, HD, WS)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, 1)
    with pytest.raises(TypeError, match="float32"):
        wa.fused_window_mhsa(p["qkv"].half(), p["bias"], NH, HD, WS)
    with pytest.raises(ValueError, match="contiguous"):
        wa.fused_window_mhsa(p["qkv"].transpose(1, 2), p["bias"], NH, HD, WS)
    with pytest.raises(ValueError, match="limits"):
        fb.fused_attn_block(p["x"][:, :60], *[p[k] for k in (
            "g", "be", "wq", "bq", "wp", "bp", "bias", "s")], NH, HD, WS)


@pytest.mark.cuda
def test_shared_memory_plans_match_the_sources(cuda):
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    lib_fb = cuda_build.library("fused_block")
    lib_tr = cuda_build.library("fused_block_train")
    lib_wa = cuda_build.library("window_attention")
    lib_st = cuda_build.library("attn_block_staged")
    for c, nh, hidden in ((180, 6, 360), (240, 8, 480), (60, 6, 120)):
        for ws in (8, 12):
            assert lib_fb.trr_attn_block_smem_bytes(c, ws) == fb.attn_block_smem_bytes(c, ws)
        assert lib_fb.trr_ln_mlp_smem_bytes(c) == fb.ln_mlp_smem_bytes(c)
        for ws in (8, 16):
            assert lib_wa.trr_window_mhsa_smem_bytes(c, nh, ws) == wa.window_mhsa_smem_bytes(
                c, nh, ws)
            assert lib_wa.trr_window_mhsa_bwd_smem_bytes(c, nh, ws) == (
                wa.window_mhsa_bwd_smem_bytes(c, nh, ws))
        assert lib_tr.trr_rows_smem_bytes(c) == fb.rows_smem_bytes(c)
        if fb.swin_block_train_fits(16, 16, 8, c, nh, hidden):  # the bf16 forms' plans fit too
            assert max(lib_tr.trr_linear_bf16_smem_bytes(n) for n in (c, 3 * c, hidden)) <= (
                wa.SMEM_LIMIT)
            assert lib_tr.trr_rows_bf16_smem_bytes(c) <= wa.SMEM_LIMIT
        for ws in (8, 12):  # the saved-P backward (#10)
            assert lib_st.trr_attn_train_bwd_smem_bytes(c, nh, ws) == (
                fb.attn_train_bwd_smem_bytes(c, nh, ws))
    for c in (300, 90):  # the forwards' residual product on 128-column tiles; a 96-column row
        assert lib_fb.trr_ln_mlp_smem_bytes(c) == fb.ln_mlp_smem_bytes(c)
    assert lib_tr.trr_hidden_smem_bytes() == fb.mlp_hidden_smem_bytes()
    assert lib_tr.trr_atb_smem_bytes() == fb.weight_grad_smem_bytes()
    assert max(lib_tr.trr_hidden_bf16_smem_bytes(), lib_tr.trr_atb_bf16_smem_bytes()) <= (
        wa.SMEM_LIMIT)
    for c in (240, 180, 60, 256):  # the bf16 attention half (#1/#6) at 12x12 windows
        assert lib_tr.trr_attn_block_bf16_smem_bytes(c) == fb.attn_block_bf16_smem_bytes(c)
        assert fb.attn_block_bf16_smem_bytes(c) <= wa.SMEM_LIMIT


@pytest.mark.cuda
def test_block_forwards_are_deterministic(cuda):
    """#4 (out, P, att, z) and #2 run on the tensor-core stages without
    atomics: two calls give the same bits."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 4)
    ops = [p[k] for k in TRAIN_NAMES]
    runs = [fb._swin_block_train_fwd_cuda(*ops, p["s"], p["s2"], NH, HD, WS, 1e-5, WS // 2)
            for _ in range(2)]
    for name, a, b in zip(("out", "P", "att", "z"), *runs):
        assert torch.equal(a, b), name
    args = [p[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2", "s")]
    with torch.no_grad():
        assert torch.equal(fb.fused_ln_mlp(*args, WS), fb.fused_ln_mlp(*args, WS))


@pytest.mark.cuda
@pytest.mark.parametrize(("c", "nh", "hidden"), [(240, 8, 480), (300, 10, 300), (90, 3, 182)],
                         ids=["c240", "c300", "c90"])
def test_block_forwards_at_other_widths(cuda, c, nh, hidden):
    """#1 at 8x8 windows and #2 against their plain versions at B=2,
    16x24, K=4 shifted: at SwinIR-L's C 240 / hidden 480 (a 256-column row;
    #2 also SRFormerV2's), at C 300 / hidden 300 (serving only: 128-column
    tiles of the residual products, LayerNorm rows above 256), and at C 90 /
    hidden 182, which are not multiples of 4 (4-byte copies, a float at a
    time)."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(c)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x, s = randn(2, 16, 24, c), torch.tensor([1.0, 0.0], device=cuda)
    g, be = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
    mlp = (randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
           randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1))
    with torch.no_grad():
        got = fb.fused_ln_mlp(x, g, be, *mlp, s, WS)
    assert (got - fb.fused_ln_mlp_reference(x, g, be, *mlp, s, WS)).abs().max().item() <= TOL
    masks = torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(cuda)
    bias = (randn(nh, N, N, scale=0.5)[None] + masks[:, None]).contiguous()
    attn = (randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5),
            randn(c, scale=0.1), bias, s)
    with torch.no_grad():
        z = fb.fused_attn_block(x, g, be, *attn, nh, c // nh, WS, shift=WS // 2)
    want = fb.fused_attn_block_reference(x, g, be, *attn, nh, c // nh, WS, shift=WS // 2)
    assert (z - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_forwards_refuse_unaligned_operands(cuda):
    """The forwards' stages move rows with 16-byte loads and copies: #1, #2,
    #4 and #9 refuse a tensor that does not start on a 16-byte boundary."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    x = torch.empty(p["x"].numel() + 1, device=cuda)[1:].view(p["x"].shape)
    x.copy_(p["x"])
    attn = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp", "bias", "s")]
    with pytest.raises(ValueError, match="16-byte"), torch.no_grad():
        fb.fused_attn_block(x, *attn, NH, HD, WS)
    with pytest.raises(ValueError, match="16-byte"), torch.no_grad():
        fb.fused_ln_mlp(x, *[p[k] for k in ("g", "be", "w1", "b1", "w2", "b2", "s")], WS)
    with pytest.raises(ValueError, match="16-byte"):
        fb._attn_block_train_fwd_cuda(x, *attn, NH, HD, WS, 1e-5, 0)
    ops = [x] + [p[k] for k in TRAIN_NAMES[1:]]
    with pytest.raises(ValueError, match="16-byte"):
        fb._swin_block_train_fwd_cuda(*ops, p["s"], p["s2"], NH, HD, WS, 1e-5, 0)


TRAIN_NAMES = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2",
               "b2")


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift", "shape"), [
    (1, 0, (B, H, W)), (4, WS // 2, (B, H, W)),
    # 960 tokens: the last 128-token tile of the backward's kernels is ragged
    (1, 0, (1, 24, 40)), (4, WS // 2, (1, 24, 40)),
])
def test_swin_block_train_kernels(cuda, kinds, shift, shape):
    """#4 (out, P, att, z) and #5 (dx and the 13 parameter gradients)
    against their plain versions."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, kinds, shape=shape)
    ops = [p[k] for k in TRAIN_NAMES]
    meta = (NH, HD, WS, 1e-5, shift)
    got = fb._swin_block_train_fwd_cuda(*ops, p["s"], p["s2"], *meta)
    want = fb.fused_swin_block_train_reference(*ops, p["s"], p["s2"], *meta)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "P", "att", "z"), got, want):
        assert (g - w).abs().max().item() <= TOL, name
    dout = torch.randn(*shape, C, generator=torch.Generator().manual_seed(7)).to(cuda)
    saved = [t for k, t in zip(TRAIN_NAMES, ops) if k != "bias"]
    n0 = fb.fused_swin_block_train_backward.launches
    grads = fb.fused_swin_block_train_backward(*saved, p["s"], p["s2"], *want[1:], dout, kinds,
                                               *meta)
    torch.cuda.synchronize()
    assert fb.fused_swin_block_train_backward.launches == n0 + 1
    plain = fb.fused_swin_block_train_bwd_reference(*saved, p["s"], p["s2"], *want[1:], dout,
                                                    kinds, *meta)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert g.shape == w.shape, i
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), i


BF16_TOL = 1e-2  # of each tensor's largest magnitude
BF16_STEP = 2.0**-8  # one bf16 step of it ...
BF16_FAR_SHARE = 1e-3  # ... which at most this share of the elements exceed


def _bf16_case(p):
    """The bf16 training block's operands: x in bf16, the parameters fp32."""
    ops = [p[k] for k in TRAIN_NAMES]
    ops[0] = ops[0].bfloat16()
    return ops


def _assert_bf16_close(name, got, want):
    assert got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    top, err = w.abs().max().item(), (g - w).abs()
    assert err.max().item() <= BF16_TOL * top, f"{name}: {err.max().item():.3g} of {top:.3g}"
    far = (err > BF16_STEP * top).float().mean().item()
    assert far <= BF16_FAR_SHARE, f"{name}: {far:.3g} of the elements beyond one bf16 step"


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift", "shape"), [
    (1, 0, (B, H, W)), (4, WS // 2, (B, H, W)), (4, WS // 2, (1, 24, 40)),
])
def test_swin_block_train_bf16_kernels(cuda, kinds, shift, shape):
    """#4's bf16 form (out, P, att, z in bf16) and #5's (dx in bf16, the 13
    parameter gradients in fp32) against their bf16 plain versions; #5 from
    the plain forward's P, att and z, each counted once."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, kinds, shape=shape)
    ops = _bf16_case(p)
    meta = (NH, HD, WS, 1e-5, shift)
    n0 = (fb.fused_swin_block_train_bf16.launches, fb.fused_swin_block_train.launches)
    got = fb._swin_block_train_fwd_cuda(*ops, p["s"], p["s2"], *meta)
    want = fb.fused_swin_block_train_bf16_reference(*ops, p["s"], p["s2"], *meta)
    torch.cuda.synchronize()
    assert (fb.fused_swin_block_train_bf16.launches, fb.fused_swin_block_train.launches) == (
        n0[0] + 1, n0[1])
    for name, g, w in zip(("out", "P", "att", "z"), got, want):
        _assert_bf16_close(name, g, w)
    dout = torch.randn(*shape, C, generator=torch.Generator().manual_seed(7)).to(cuda).bfloat16()
    saved = [t for k, t in zip(TRAIN_NAMES, ops) if k != "bias"]
    n1 = (fb.fused_swin_block_train_backward_bf16.launches,
          fb.fused_swin_block_train_backward.launches)
    grads = fb.fused_swin_block_train_backward(*saved, p["s"], p["s2"], *want[1:], dout, kinds,
                                               *meta)
    torch.cuda.synchronize()
    assert (fb.fused_swin_block_train_backward_bf16.launches,
            fb.fused_swin_block_train_backward.launches) == (n1[0] + 1, n1[1])
    plain = fb.fused_swin_block_train_bwd_bf16_reference(*saved, p["s"], p["s2"], *want[1:],
                                                         dout, kinds, *meta)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * w.float().abs().max(), i


@pytest.mark.cuda
def test_swin_block_train_bf16_at_swinir_s(cuda):
    """The bf16 forms at SwinIR-S's block (C 60, 6 heads of 10, hidden 120:
    64-column tiles, heads padded from 10 to 32 channels)."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    c, nh, hidden, shift = 60, 6, 120, WS // 2
    gen = torch.Generator().manual_seed(60)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    masks = torch.from_numpy(shift_mask_kinds(WS, shift)).to(cuda)
    ops = [randn(2, 32, 48, c).bfloat16(), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
           randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5),
           randn(c, scale=0.1), (randn(nh, N, N, scale=0.5)[None] + masks[:, None]).contiguous(),
           1.0 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5),
           randn(hidden, scale=0.1), randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1)]
    s1, s2 = torch.tensor([1.0, 0.8], device=cuda), torch.tensor([0.0, 1 / 0.9], device=cuda)
    meta = (nh, c // nh, WS, 1e-5, shift)
    got = fb.fused_swin_block_train_bf16(*ops, s1, s2, *meta)
    want = fb.fused_swin_block_train_bf16_reference(*ops, s1, s2, *meta)
    for name, g, w in zip(("out", "P", "att", "z"), got, want):
        _assert_bf16_close(name, g, w)
    dout = randn(2, 32, 48, c).bfloat16()
    saved = [t for i, t in enumerate(ops) if i != 7]
    grads = fb.fused_swin_block_train_backward_bf16(*saved, s1, s2, *want[1:], dout, 4, *meta)
    plain = fb.fused_swin_block_train_bwd_bf16_reference(*saved, s1, s2, *want[1:], dout, 4,
                                                         *meta)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * w.float().abs().max(), i


@pytest.mark.cuda
def test_swin_block_train_bf16_is_deterministic(cuda):
    """The bf16 forms use no atomics: two forwards and backwards, the same
    bits."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 4)
    ops = [t.clone().requires_grad_() for t in _bf16_case(p)]
    runs = []
    for _ in range(2):
        out = fb.fused_swin_block_train(*ops, p["s"], p["s2"], NH, HD, WS, 1e-5, shift=WS // 2)
        runs.append((out, *torch.autograd.grad(out.float().square().sum(), ops)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fp32_kernels_refuse_bf16(cuda):
    """The attention half's bf16 forms take 12x12 windows only: a bf16
    tensor at 8x8 windows that reaches #1 raises, naming the limits, and
    one that reaches #9 (no bf16 form) raises on its type; neither is cast
    nor falls back. The bf16 forms of #2 and #3 refuse an fp32 parameter
    where they take bf16 and a width they do not take, and are never run
    in fp32."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, 1)
    x = p["x"].bfloat16()
    attn = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp", "bias", "s")]
    n0 = (fb.fused_attn_block_bf16.launches, fb.fused_attn_block.launches)
    with pytest.raises(ValueError, match="bf16 kernels' limits"), torch.no_grad():
        fb.fused_attn_block(x, *attn, NH, HD, WS)
    assert (fb.fused_attn_block_bf16.launches, fb.fused_attn_block.launches) == n0
    with pytest.raises(TypeError, match="bfloat16"), torch.no_grad():
        wa.fused_window_mhsa_bf16(p["qkv"], p["bias"], NH, HD, WS)
    with pytest.raises(TypeError, match="float32"):
        fb._attn_block_train_fwd_cuda(x, *attn, NH, HD, WS, 1e-5, 0)
    wide = torch.zeros(1, 8, 8, 260, device=cuda, dtype=torch.bfloat16)
    mlp = [torch.ones(260, device=cuda), torch.zeros(260, device=cuda),
           torch.zeros(260, 520, device=cuda), torch.zeros(520, device=cuda),
           torch.zeros(520, 260, device=cuda), torch.zeros(260, device=cuda),
           torch.ones(1, device=cuda)]
    with pytest.raises(ValueError, match="bf16 kernels' limits"), torch.no_grad():
        fb.fused_ln_mlp(wide, *mlp, 8)


@pytest.mark.cuda
def test_swin_block_train_backward_is_deterministic(cuda):
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 4)
    ops = [p[k].clone().requires_grad_() for k in TRAIN_NAMES]
    runs = []
    for _ in range(2):
        out = fb.fused_swin_block_train(*ops, p["s"], p["s2"], NH, HD, WS, 1e-5, shift=WS // 2)
        runs.append(torch.autograd.grad(out.square().sum(), ops))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_forward_only_kernels_refuse_autograd(cuda):
    """#1 was forward only; with #6 ported it carries its gradient at 8x8
    windows too (the staged backward at n = 64): under autograd it returns
    the plain version's gradients, under no_grad it runs as before."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 4)
    names = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias")
    ops = [p[k].clone().requires_grad_() for k in names]
    n0 = fb.fused_attn_block_backward.launches
    z = fb.fused_attn_block(*ops, p["s"], NH, HD, WS, shift=WS // 2)
    got = torch.autograd.grad(z.square().sum(), ops)
    torch.cuda.synchronize()
    assert fb.fused_attn_block_backward.launches == n0 + 1
    plain = fb.fused_attn_block_bwd_reference(*[p[k] for k in names], p["s"], 2 * z.detach(),
                                              NH, HD, WS, shift=WS // 2)
    for name, g, w in zip(names, got, plain):
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name
    with torch.no_grad():
        fb.fused_attn_block(*[p[k] for k in names], p["s"], NH, HD, WS)


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [1, 4])
def test_fused_window_mhsa_ws16_kernel(cuda, kinds):
    """#3 at HAT's 16x16 windows (n = 256)."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, kinds, ws=16)
    n0 = wa.fused_window_mhsa.launches
    got = wa.fused_window_mhsa(p["qkv"], p["bias"], NH, HD, 16)
    torch.cuda.synchronize()
    assert wa.fused_window_mhsa.launches == n0 + 1
    want = wa.fused_window_mhsa_reference(p["qkv"], p["bias"], NH, HD, 16)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize(("ws", "kinds"), [(8, 1), (8, 4), (16, 1), (16, 4)])
def test_fused_window_mhsa_backward_kernel(cuda, ws, kinds):
    """#8 (dqkv and dbias) against its plain version."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, kinds, ws=ws)
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
    n0 = wa.fused_window_mhsa_backward.launches
    got = wa.fused_window_mhsa_backward(p["qkv"], p["bias"], dout, NH, HD, ws)
    torch.cuda.synchronize()
    assert wa.fused_window_mhsa_backward.launches == n0 + 1
    want = wa.fused_window_mhsa_bwd_reference(p["qkv"], p["bias"], dout, NH, HD, ws)
    for name, g, w in zip(("dqkv", "dbias"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name


@pytest.mark.cuda
def test_fused_window_mhsa_backward_is_deterministic(cuda):
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, 4, ws=16)
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
    runs = [wa.fused_window_mhsa_backward(p["qkv"], p["bias"], dout, NH, HD, 16) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_ln_mlp_backward_kernel(cuda):
    """#7 (dx and the six parameter gradients) against its plain version,
    also on a ragged last tile of tokens (96 and 960 tokens against tiles of
    128)."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    gen = torch.Generator().manual_seed(8)
    for x, s in ((p["x"], p["s2"]), (torch.randn(1, 8, 12, C, generator=gen).to(cuda),
                                     torch.ones(1, device=cuda)),
                 (torch.randn(1, 24, 40, C, generator=gen).to(cuda),
                  torch.full((1,), 1.0 / 0.9, device=cuda))):
        dout = torch.randn(x.shape, generator=gen).to(cuda)
        n0 = fb.fused_ln_mlp_backward.launches
        got = fb.fused_ln_mlp_backward(x, *params, s, dout, WS)
        torch.cuda.synchronize()
        assert fb.fused_ln_mlp_backward.launches == n0 + 1
        want = fb.fused_ln_mlp_bwd_reference(x, *params, s, dout, WS)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, i
            assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), i


@pytest.mark.cuda
def test_window_and_mlp_kernels_carry_gradients(cuda):
    """fused_window_mhsa (ws 16) and fused_ln_mlp under autograd on the card:
    the kernels both ways, the gradients those of the plain versions."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    p = _inputs(cuda, 4, ws=16)
    cases = {
        "window": (lambda q, t: wa.fused_window_mhsa(q, t, NH, HD, 16),
                   lambda q, t: wa.fused_window_mhsa_reference(q, t, NH, HD, 16),
                   [p["qkv"], p["bias"]]),
        "mlp": (lambda *a: fb.fused_ln_mlp(*a, p["s2"], WS),
                lambda *a: fb.fused_ln_mlp_reference(*a, p["s2"], WS),
                [p[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2")]),
    }
    for name, (kern, plain, ops) in cases.items():
        grads = []
        for fn in (kern, plain):
            leaves = [t.clone().requires_grad_() for t in ops]
            out = fn(*leaves)
            grads.append(torch.autograd.grad(out.square().sum(), leaves))
        for i, (g, w) in enumerate(zip(*grads)):
            assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), (name, i)


@pytest.mark.cuda
def test_swinir_m_branches_agree_on_card(cuda, monkeypatch):
    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swinir_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(1, 3, 40, 56, generator=torch.Generator().manual_seed(1)).to(cuda)
    outs = {}
    for branch, env in (("fused", {}), ("unfused", {"TRAINNER_FUSED_BLOCK": "0"}),
                        ("plain", {"TRAINNER_FUSED_ATTN": "0"})):
        for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with torch.inference_mode():
            outs[branch] = net(x).cpu().numpy()
    assert outs["plain"].shape == (1, 3, 160, 224)
    for branch in ("fused", "unfused"):
        np.testing.assert_allclose(outs[branch], outs["plain"], atol=1e-3, rtol=0)


# DAT's branches: (h_sp, w_sp) -> the shift of a shifted block
RECT = {(8, 32): (4, 16), (32, 8): (16, 4), (8, 16): (4, 8), (16, 8): (8, 4)}
RC, RNH = 90, 3


def _rect_inputs(device, window, kinds, seed=0):
    from trainner_redux_tpu_torch.ops.window_attention import rect_shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)
    n = window[0] * window[1]
    qkv = torch.randn(B, 64, 64, 3 * RC, generator=gen).to(device)
    rel = (torch.randn(RNH, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        masks = torch.from_numpy(rect_shift_mask_kinds(*window, *RECT[window])).to(device)
        rel = rel[None] + masks[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(B, 64, 64, RC, generator=gen).to(device)
    return qkv, rel.contiguous(), dout


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize("window", list(RECT))
def test_fused_rect_mhsa_kernels(cuda, window, kinds):
    """#3 and #8 in their rect forms against their plain versions."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _rect_inputs(cuda, window, kinds)
    hd = RC // RNH
    n0 = (wa.fused_rect_mhsa.launches, wa.fused_rect_mhsa_backward.launches)
    with torch.no_grad():
        got = wa.fused_rect_mhsa(qkv, bias, RNH, hd, *window)
    grads = wa.fused_rect_mhsa_backward(qkv, bias, dout, RNH, hd, *window)
    torch.cuda.synchronize()
    assert (wa.fused_rect_mhsa.launches, wa.fused_rect_mhsa_backward.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = wa.fused_rect_mhsa_reference(qkv, bias, RNH, hd, *window)
    assert (got - want).abs().max().item() <= TOL
    plain = wa.fused_rect_mhsa_bwd_reference(qkv, bias, dout, RNH, hd, *window)
    for name, g, w in zip(("dqkv", "dbias"), grads, plain):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name


@pytest.mark.cuda
def test_fused_rect_mhsa_backward_is_deterministic(cuda):
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _rect_inputs(cuda, (32, 8), 4)
    runs = [wa.fused_rect_mhsa_backward(qkv, bias, dout, RNH, RC // RNH, 32, 8)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(8, 8), (16, 16), (8, 32), (32, 8), (8, 16), (16, 8)],
                         ids=lambda w: f"{w[0]}x{w[1]}")
def test_window_mhsa_forward_is_deterministic(cuda, window):
    """#3 on the tensor-core window attention (no atomics) at each form:
    two calls give the same bits."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    c, nh = (C, NH) if window[0] == window[1] else (RC, RNH)
    qkv = torch.randn(2, 64, 64, 3 * c, generator=torch.Generator().manual_seed(21)).to(cuda)
    n = window[0] * window[1]
    bias = torch.randn(1, nh, n, n, generator=torch.Generator().manual_seed(22)).to(cuda)
    with torch.no_grad():
        runs = [wa.fused_rect_mhsa(qkv, bias, nh, c // nh, *window) for _ in range(2)]
    assert torch.equal(*runs)
    assert (runs[0] - wa.fused_rect_mhsa_reference(qkv, bias, nh, c // nh, *window)).abs().max(
    ).item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize(("c", "nh"), [(90, 3), (150, 5), (372, 12)], ids=["c90", "c150", "c372"])
def test_fused_attn_block_ws12_at_other_widths(cuda, c, nh):
    """#1 at 12x12 windows against its plain version at B=2, 24x36, K=4
    shifted by 6: at C 90 and C 150 (not multiples of 4: 4-byte copies) and
    C 372 (a LayerNorm row above 256, which the FMA kernels took)."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(c)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x, s = randn(2, 24, 36, c), torch.tensor([1.0, 0.0], device=cuda)
    masks = torch.from_numpy(shift_mask_kinds(SWS, SWS // 2)).to(cuda)
    bias = (randn(nh, SWS**2, SWS**2, scale=0.5)[None] + masks[:, None]).contiguous()
    args = (x, 1.0 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5),
            randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5), randn(c, scale=0.1), bias, s)
    with torch.no_grad():
        z = fb.fused_attn_block(*args, nh, c // nh, SWS, shift=SWS // 2)
    want = fb.fused_attn_block_reference(*args, nh, c // nh, SWS, shift=SWS // 2)
    assert (z - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_fused_rect_mhsa_refuses_what_the_kernels_do_not_take(cuda):
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _rect_inputs(cuda, (8, 32), 1)
    hd = RC // RNH
    with pytest.raises(ValueError, match="limits"):  # H = 60 is not a multiple of 8
        wa.fused_rect_mhsa(qkv[:, :60].contiguous(), bias, RNH, hd, 8, 32)
    with pytest.raises(ValueError, match="limits"):  # n = 512
        wa.fused_rect_mhsa(qkv, torch.zeros(1, RNH, 512, 512, device=cuda), RNH, hd, 16, 32)
    with pytest.raises(TypeError, match="float32"):
        wa.fused_rect_mhsa_backward(qkv.double(), bias, dout, RNH, hd, 8, 32)
    with pytest.raises(ValueError, match="shape"):  # the table of 16x16 windows
        wa.fused_rect_mhsa(qkv, torch.zeros(1, RNH, 128, 128, device=cuda), RNH, hd, 8, 32)


@pytest.mark.cuda
def test_rect_shared_memory_plans_match_the_source(cuda):
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import window_attention as wa

    lib = cuda_build.library("window_attention")
    for c, nh in ((90, 3), (30, 3), (180, 6)):
        for window in list(RECT) + [(8, 8), (16, 16)]:
            assert lib.trr_rect_mhsa_smem_bytes(c, nh, *window) == wa.rect_mhsa_smem_bytes(
                c, nh, *window)
            assert lib.trr_rect_mhsa_bwd_smem_bytes(c, nh, *window) == (
                wa.rect_mhsa_bwd_smem_bytes(c, nh, *window))


@pytest.mark.cuda
def test_dat_branches_agree_on_card(cuda, monkeypatch):
    """A DAT 4x (two groups of two blocks at DAT's widths) in train mode,
    one forward and backward through the rect kernels and the plain
    branch: the same loss and gradients."""
    import copy

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.archs.dat_arch import ZERO_GRAD_PARAMS
    from trainner_redux_tpu_torch.ops import window_attention as wa

    net = build_network({"type": "dat", "scale": 4, "depth": [2, 2], "num_heads": [6, 6],
                         "drop_path_rate": 0.0})
    net = net.init_weights(torch.Generator().manual_seed(0)).to(cuda).train()
    nets = {"kernel": net, "plain": copy.deepcopy(net)}
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, 48, 40, generator=gen).to(cuda)  # qkv padded to 64x64
    losses, grads = {}, {}
    for branch, m in nets.items():
        monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
        if branch == "plain":
            monkeypatch.setenv("TRAINNER_FUSED_ATTN", "0")
        n0 = wa.fused_rect_mhsa_backward.launches
        loss = m(x).square().mean()
        loss.backward()
        assert wa.fused_rect_mhsa_backward.launches - n0 == (4 if branch == "kernel" else 0)
        losses[branch] = loss.item()
        grads[branch] = {k: p.grad for k, p in m.named_parameters() if p.grad is not None}
    assert abs(losses["kernel"] - losses["plain"]) <= 1e-4 * abs(losses["plain"])
    assert set(grads["kernel"]) == set(grads["plain"])
    # a true gradient of 0 is held against the largest gradient of all
    gmax = max(w.abs().max().item() for w in grads["plain"].values())
    for k, w in grads["plain"].items():
        ref = gmax if k.endswith(ZERO_GRAD_PARAMS) else w.abs().max().item()
        assert (grads["kernel"][k] - w).abs().max().item() <= 1e-3 * ref, k


# Swin2SR's post-norm halves (#11-#14): the operand order of the wrappers
COS_NAMES = ("x", "wq", "bq", "scale", "wp", "bp", "g", "be", "bias")
PN_NAMES = ("x", "w1", "b1", "w2", "b2", "g2", "be2")


def _v2_inputs(device, kinds, seed=0, shape=(B, H, W)):
    """SwinIR-M-wide inputs plus the temperatures exp(min(logit, log 100)),
    between 1 and 100, that the cosine attention takes."""
    p = _inputs(device, kinds, seed, shape=shape)
    gen = torch.Generator().manual_seed(seed + 100)
    p["scale"] = torch.exp(torch.rand(NH, generator=gen) * 4.6).to(device)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift", "shape"), [(1, 0, (B, H, W)), (4, 0, (B, H, W)),
                                                       (4, WS // 2, (B, H, W)),
                                                       (4, WS // 2, (1, 16, 40))])
def test_fused_cos_attn_block_kernels(cuda, kinds, shift, shape):
    """#11 (z) and #12 (dx and the eight parameter gradients) against their
    plain versions; 1 x 16 x 40 leaves #12's engine stages a ragged last
    tile of 128 tokens."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, kinds, shape=shape)
    ops = [p[k] for k in COS_NAMES]
    meta = (NH, HD, WS, 1e-5, shift)
    dout = torch.randn(*p["x"].shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    n0 = (v2.fused_cos_attn_block.launches, v2.fused_cos_attn_block_backward.launches)
    with torch.no_grad():
        got = v2.fused_cos_attn_block(*ops, p["s2"], *meta)
    grads = v2.fused_cos_attn_block_backward(*ops, p["s2"], dout, *meta)
    torch.cuda.synchronize()
    assert (v2.fused_cos_attn_block.launches, v2.fused_cos_attn_block_backward.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = v2.fused_cos_attn_block_reference(*ops, p["s2"], *meta)
    assert (got - want).abs().max().item() <= TOL
    plain = v2.fused_cos_attn_block_bwd_reference(*ops, p["s2"], dout, *meta)
    names = ("dx", "dwq", "dbq", "dscale", "dwp", "dbp", "dg", "dbe", "dbias")
    for name, g, w in zip(names, grads, plain):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name


@pytest.mark.cuda
def test_fused_postnorm_mlp_kernels(cuda):
    """#13 (out) and #14 (dx and the six parameter gradients) against their
    plain versions, also on a ragged last tile of tokens."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, 1)
    params = [p[k] for k in PN_NAMES[1:]]
    gen = torch.Generator().manual_seed(8)
    for x, s in ((p["x"], p["s2"]), (torch.randn(1, 8, 12, C, generator=gen).to(cuda),
                                     torch.ones(1, device=cuda))):
        dout = torch.randn(x.shape, generator=gen).to(cuda)
        n0 = (v2.fused_postnorm_mlp.launches, v2.fused_postnorm_mlp_backward.launches)
        with torch.no_grad():
            got = v2.fused_postnorm_mlp(x, *params, s, WS)
        grads = v2.fused_postnorm_mlp_backward(x, *params, s, dout, WS)
        torch.cuda.synchronize()
        assert (v2.fused_postnorm_mlp.launches, v2.fused_postnorm_mlp_backward.launches) == (
            n0[0] + 1, n0[1] + 1)
        assert (got - v2.fused_postnorm_mlp_reference(x, *params, s, WS)).abs().max() <= TOL
        plain = v2.fused_postnorm_mlp_bwd_reference(x, *params, s, dout, WS)
        for i, (g, w) in enumerate(zip(grads, plain)):
            assert g.shape == w.shape, i
            assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), i


@pytest.mark.cuda
def test_fused_postnorm_mlp_at_c240_kernels(cuda):
    """#13 and #14 at Swin2SR-L's MLP half (C 240, hidden 480), which #14
    trains on the tensor-core engine: against their plain versions, two
    backward runs bit-identical."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    gen = torch.Generator().manual_seed(9)
    c, hidden = 240, 480

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x = randn(2, 24, 40, c)
    params = [randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
              randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1),
              1.0 + randn(c, scale=0.1), randn(c, scale=0.1)]
    s = torch.tensor([0.0, 1.0 / 0.9], device=cuda)
    dout = randn(*x.shape)
    assert v2.pn_mlp_fits(24, WS, c, hidden, train=True)
    with torch.no_grad():
        got = v2.fused_postnorm_mlp(x, *params, s, WS)
    grads = v2.fused_postnorm_mlp_backward(x, *params, s, dout, WS)
    again = v2.fused_postnorm_mlp_backward(x, *params, s, dout, WS)
    torch.cuda.synchronize()
    assert (got - v2.fused_postnorm_mlp_reference(x, *params, s, WS)).abs().max() <= TOL
    plain = v2.fused_postnorm_mlp_bwd_reference(x, *params, s, dout, WS)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert g.shape == w.shape, i
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), i
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_postnorm_backwards_are_deterministic(cuda):
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, 4)
    p1 = _v2_inputs(cuda, 1)
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
    cos = [p[k] for k in COS_NAMES]
    cos1 = [p1[k] for k in COS_NAMES]
    mlp = [p[k] for k in PN_NAMES]
    for fn in (lambda: v2.fused_cos_attn_block_backward(*cos, p["s2"], dout, NH, HD, WS,
                                                        shift=WS // 2),
               lambda: v2.fused_cos_attn_block_backward(*cos1, p1["s2"], dout, NH, HD, WS),
               lambda: v2.fused_postnorm_mlp_backward(*mlp, p["s2"], dout, WS)):
        runs = [fn() for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_postnorm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, 1)
    cos = [p[k] for k in COS_NAMES]
    with pytest.raises(TypeError, match="float32"):
        v2.fused_cos_attn_block(cos[0].double(), *cos[1:], p["s"], NH, HD, WS)
    with pytest.raises(ValueError, match="contiguous"):
        v2.fused_cos_attn_block(cos[0].transpose(1, 2).contiguous().transpose(1, 2), *cos[1:],
                                p["s"], NH, HD, WS)
    with pytest.raises(ValueError, match="limits"):  # H = 60 is not a multiple of 8
        v2.fused_cos_attn_block(cos[0][:, :60].contiguous(), *cos[1:], p["s"], NH, HD, WS)
    with pytest.raises(ValueError, match="shape"):  # one temperature for 6 heads
        v2.fused_cos_attn_block(*cos[:3], p["scale"][:1], *cos[4:], p["s"], NH, HD, WS)
    x = torch.empty(cos[0].numel() + 1, device=cuda)[1:].view(cos[0].shape)
    with pytest.raises(ValueError, match="16-byte"):  # the engine's 16-byte rows
        v2.fused_cos_attn_block_backward(x, *cos[1:], p["s"], x, NH, HD, WS)
    with pytest.raises(ValueError, match="limits"):  # rows the engine does not take: C 90
        x = torch.zeros(1, 8, 8, 90, device=cuda)
        w1, w2 = torch.zeros(90, 180, device=cuda), torch.zeros(180, 90, device=cuda)
        v2.fused_postnorm_mlp_backward(x, w1, torch.zeros(180, device=cuda), w2,
                                       *(torch.zeros(90, device=cuda) for _ in range(3)),
                                       torch.ones(1, device=cuda), x, WS)
    x = torch.empty(cos[0].numel() + 1, device=cuda)[1:].view(cos[0].shape)
    mlp = [p[k] for k in PN_NAMES[1:]]
    with pytest.raises(ValueError, match="16-byte"):  # #14 runs on the engine too
        v2.fused_postnorm_mlp_backward(x, *mlp, p["s"], x, WS)


@pytest.mark.cuda
@pytest.mark.parametrize(("c", "nh", "hidden"), [(90, 3, 180), (180, 6, 362), (264, 12, 264)])
def test_postnorm_forwards_at_widths_the_backwards_do_not_take(cuda, c, nh, hidden):
    """#11 and #13 at widths only the forwards take: C 90 (rows not in
    16-byte pieces: the stages move them a float at a time), a hidden width
    of 362, C 264 (wider than one rows_kernel tile); K=4 shifted, against
    their plain versions; a forward refuses an x off a 16-byte boundary."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(c + hidden)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x, s = randn(2, 16, 24, c), torch.tensor([0.0, 1.0 / 0.9], device=cuda)
    bias = (16.0 * torch.sigmoid(randn(nh, N, N)))[None] + torch.from_numpy(
        shift_mask_kinds(WS, WS // 2)).to(cuda)[:, None]
    cos = [x, randn(c, 3 * c, scale=c**-0.5), randn(3 * c, scale=0.1),
           torch.exp(torch.rand(nh, generator=gen) * 4.6).to(cuda), randn(c, c, scale=c**-0.5),
           randn(c, scale=0.1), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
           bias.contiguous()]
    mlp = [x, randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
           randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1), 1.0 + randn(c, scale=0.1),
           randn(c, scale=0.1)]
    meta = (nh, c // nh, WS, 1e-5, WS // 2)
    assert v2.cos_attn_fits(16, 24, WS, c, nh) and v2.pn_mlp_fits(16, WS, c, hidden)
    with torch.no_grad():
        z = v2.fused_cos_attn_block(*cos, s, *meta)
        out = v2.fused_postnorm_mlp(*mlp, s, WS)
    assert (z - v2.fused_cos_attn_block_reference(*cos, s, *meta)).abs().max().item() <= TOL
    assert (out - v2.fused_postnorm_mlp_reference(*mlp, s, WS)).abs().max().item() <= TOL
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        v2.fused_cos_attn_block(off, *cos[1:], s, *meta)
    with pytest.raises(ValueError, match="16-byte"):
        v2.fused_postnorm_mlp(off, *mlp[1:], s, WS)


@pytest.mark.cuda
def test_postnorm_shared_memory_plans_match_the_source(cuda):
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    lib = cuda_build.library("fused_block_v2")
    for c, nh, hidden in ((180, 6, 360), (240, 8, 480), (60, 6, 120)):
        assert lib.trr_cos_attn_fwd_smem_bytes(c) == v2.cos_attn_fwd_smem_bytes(c)
        assert lib.trr_pn_mlp_fwd_smem_bytes(c) == v2.pn_mlp_fwd_smem_bytes(c)
        assert lib.trr_cos_attn_bwd_smem_bytes() == v2.cos_attn_bwd_smem_bytes()
        assert lib.trr_pn_mlp_bwd_smem_bytes(c, hidden) == v2.pn_mlp_bwd_smem_bytes(c, hidden)


@pytest.mark.cuda
def test_swin2sr_branches_agree_on_card(cuda, monkeypatch):
    """A Swin2SR 4x (two groups of two blocks at Swin2SR-M's widths) in train
    mode, one forward and backward through #11-#14 and the unfused branch:
    the same loss and gradients, logit_scale and the CPB MLP included."""
    import copy

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    net = build_network({"type": "swin2sr_m", "scale": 4, "depths": [2, 2], "num_heads": [6, 6],
                         "drop_path_rate": 0.0})
    net = net.init_weights(torch.Generator().manual_seed(0)).to(cuda).train()
    nets = {"kernel": net, "plain": copy.deepcopy(net)}
    x = torch.rand(2, 3, 40, 48, generator=torch.Generator().manual_seed(1)).to(cuda)
    losses, grads = {}, {}
    for branch, m in nets.items():
        monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
        if branch == "plain":
            monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "0")
        n0 = (v2.fused_cos_attn_block_backward.launches, v2.fused_postnorm_mlp_backward.launches)
        loss = m(x).square().mean()
        loss.backward()
        n1 = (v2.fused_cos_attn_block_backward.launches, v2.fused_postnorm_mlp_backward.launches)
        assert (n1[0] - n0[0], n1[1] - n0[1]) == ((4, 4) if branch == "kernel" else (0, 0))
        losses[branch] = loss.item()
        grads[branch] = {k: p.grad for k, p in m.named_parameters()}
    assert abs(losses["kernel"] - losses["plain"]) <= 1e-4 * abs(losses["plain"])
    for k, w in grads["plain"].items():
        assert (grads["kernel"][k] - w).abs().max().item() <= 1e-3 * w.abs().max().item(), k


# ---------------------------------------------------------------------------
# kernel #15: the DiffJPEG block transform
# ---------------------------------------------------------------------------


def _jpeg_inputs(device, b: int, n: int, table, seed: int = 0):
    """Level-shifted blocks of seeded smooth images and per-sample tables at
    qualities across 45-95, as the OTF compression stage draws them."""
    from trainner_redux_tpu_torch.utils.diffjpeg import quality_to_factor

    gen = torch.Generator().manual_seed(seed)
    blocks = (torch.rand(b, n, 64, generator=gen) * 60 - 30
              + torch.rand(b, n, 1, generator=gen) * 180 - 90).to(device)
    q = torch.linspace(45, 95, b)
    qtabs = torch.clamp(torch.from_numpy(table.reshape(-1))[None] * quality_to_factor(q)[:, None],
                        1.0, 255.0).to(device)
    return blocks.contiguous(), qtabs.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "table"), [(36, "Y"), (9, "C"), (4096, "Y")])
def test_jpeg_block_kernel(cuda, n, table):
    """At the OTF path's planes (batch 8, gt_size 128: 36 Y and 9 C blocks
    an image) and at 8 images of 512x512; blocks near a rounding tie are
    counted and left out."""
    from trainner_redux_tpu_torch.ops import jpeg_kernel
    from trainner_redux_tpu_torch.utils.diffjpeg import C_TABLE, Y_TABLE

    blocks, qtabs = _jpeg_inputs(cuda, 8, n, Y_TABLE if table == "Y" else C_TABLE)
    before = jpeg_kernel.jpeg_block_transform.launches
    got = jpeg_kernel.jpeg_block_transform(blocks, qtabs)
    again = jpeg_kernel.jpeg_block_transform(blocks, qtabs)
    torch.cuda.synchronize()
    assert jpeg_kernel.jpeg_block_transform.launches == before + 2
    assert torch.equal(got, again)
    want = jpeg_kernel.jpeg_block_transform_reference(blocks, qtabs)
    clear = ~jpeg_kernel.ties(blocks, qtabs).any(dim=-1)
    assert clear.float().mean() > 0.95
    torch.testing.assert_close(got[clear], want[clear], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(36, 9, 9), (4096, 36, 9)], ids=["path", "large"])
def test_jpeg_block_kernel_three_planes(cuda, sizes):
    """One launch for a compression's three planes (Y, Cb, Cr: the path's,
    on tiles of 16 blocks; and with a plane of 8 x 4096 blocks, on tiles of
    64): each plane bit for bit its own single-plane launch (a block's sums
    do not depend on its tile), bit-identical over two runs, and within
    1e-3 of the plain version with ties left out."""
    from trainner_redux_tpu_torch.ops import jpeg_kernel
    from trainner_redux_tpu_torch.utils.diffjpeg import C_TABLE, Y_TABLE

    planes = [_jpeg_inputs(cuda, 8, n, Y_TABLE if i == 0 else C_TABLE, seed=i)
              for i, n in enumerate(sizes)]
    before = jpeg_kernel.jpeg_block_transform.launches
    got = jpeg_kernel.jpeg_block_transform_planes(planes)
    again = jpeg_kernel.jpeg_block_transform_planes(planes)
    torch.cuda.synchronize()
    assert jpeg_kernel.jpeg_block_transform.launches == before + 2
    for out, out2, (blocks, qtabs) in zip(got, again, planes):
        assert torch.equal(out, out2)
        assert torch.equal(out, jpeg_kernel.jpeg_block_transform(blocks, qtabs))
        want = jpeg_kernel.jpeg_block_transform_reference(blocks, qtabs)
        clear = ~jpeg_kernel.ties(blocks, qtabs).any(dim=-1)
        torch.testing.assert_close(out[clear], want[clear], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_jpeg_block_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from trainner_redux_tpu_torch.ops import jpeg_kernel

    blocks, qtabs = torch.zeros(2, 9, 64, device=cuda), torch.ones(2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        jpeg_kernel.jpeg_block_transform(blocks.requires_grad_(True), qtabs)
    with pytest.raises(TypeError, match="float32"):
        jpeg_kernel.jpeg_block_transform(blocks.detach().double(), qtabs)
    with pytest.raises(ValueError, match="shape"):
        jpeg_kernel.jpeg_block_transform(blocks.detach(), torch.ones(3, 64, device=cuda))
    off = torch.zeros(2 * 9 * 64 + 1, device=cuda)[1:].view(2, 9, 64)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte boundary"):
        jpeg_kernel.jpeg_block_transform_planes([(blocks.detach(), qtabs), (off, qtabs)])


# SRFormerV2's Swin blocks: C 240, 8 heads of 30, 12x12 windows, hidden 480,
# at batch 2 and a 48x72 map (4 x 6 windows)
SB, SH, SW, SC, SNH, SWS, SHIDDEN = 2, 48, 72, 240, 8, 12, 480
ATTN_NAMES = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias")


def _ws12_inputs(device, kinds, seed=0):
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)
    n = SWS * SWS

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    p = {
        "x": randn(SB, SH, SW, SC), "g": 1.0 + randn(SC, scale=0.1), "be": randn(SC, scale=0.1),
        "wq": randn(SC, 3 * SC, scale=SC**-0.5), "bq": randn(3 * SC, scale=0.1),
        "wp": randn(SC, SC, scale=SC**-0.5), "bp": randn(SC, scale=0.1),
        "w1": randn(SC, SHIDDEN, scale=SC**-0.5), "b1": randn(SHIDDEN, scale=0.1),
        "w2": randn(SHIDDEN, SC, scale=SHIDDEN**-0.5), "b2": randn(SC, scale=0.1),
        "s": torch.tensor([1.0, 1.0 / 0.9], device=device),
    }
    rel = randn(SNH, n, n, scale=0.5)[None]
    if kinds == 4:
        rel = rel + torch.from_numpy(shift_mask_kinds(SWS, SWS // 2)).to(device)[:, None]
    p["bias"] = rel.contiguous()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift"), [(1, 0), (4, SWS // 2)])
def test_fused_attn_block_ws12_kernels(cuda, kinds, shift):
    """#1 at 12x12 windows (the tensor-core stages) and #6 against their
    plain versions; both bit-identical over two runs."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _ws12_inputs(cuda, kinds)
    args = [p[k] for k in ATTN_NAMES]
    hd = SC // SNH
    n0 = fb.fused_attn_block.launches
    with torch.no_grad():
        got = fb.fused_attn_block(*args, p["s"], SNH, hd, SWS, shift=shift)
        assert torch.equal(got, fb.fused_attn_block(*args, p["s"], SNH, hd, SWS, shift=shift))
    torch.cuda.synchronize()
    assert fb.fused_attn_block.launches == n0 + 2
    want = fb.fused_attn_block_reference(*args, p["s"], SNH, hd, SWS, shift=shift)
    assert (got - want).abs().max().item() <= TOL
    dout = torch.randn(got.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
    n0 = fb.fused_attn_block_backward.launches
    grads = fb.fused_attn_block_backward(*args, p["s"], dout, SNH, hd, SWS, shift=shift)
    again = fb.fused_attn_block_backward(*args, p["s"], dout, SNH, hd, SWS, shift=shift)
    torch.cuda.synchronize()
    assert fb.fused_attn_block_backward.launches == n0 + 2
    plain = fb.fused_attn_block_bwd_reference(*args, p["s"], dout, SNH, hd, SWS, shift=shift)
    for name, g, w, g2 in zip(ATTN_NAMES, grads, plain, again):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name
        assert torch.equal(g, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift", "shape"), [
    (1, 0, (SB, SH, SW)), (4, SWS // 2, (SB, SH, SW)), (1, 0, (1, 24, 36)),
])
def test_bf16_attn_block_ws12_kernels(cuda, kinds, shift, shape):
    """#1's and #6's bf16 forms at SRFormerV2's block (bf16 x and dout, fp32
    parameters) through the autograd Function against their bf16 plain
    versions, each counted once under its own name and no fp32 form
    launched; the tokens of (1, 24, 36) fill no whole 128-token tile; two
    runs bit for bit."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _ws12_inputs(cuda, kinds)
    b, h, w = shape
    x = p["x"][:b, :h, :w].contiguous().bfloat16()
    s = p["s"][:b].contiguous()
    params = [p[k].clone().requires_grad_() for k in ATTN_NAMES[1:]]
    dout = torch.randn(b, h, w, SC, generator=torch.Generator().manual_seed(13)).to(cuda)
    dout = dout.bfloat16()
    hd = SC // SNH
    tx = x.clone().requires_grad_()
    forms = (fb.fused_attn_block_bf16, fb.fused_attn_block_backward_bf16, fb.fused_attn_block,
             fb.fused_attn_block_backward)
    n0 = [f.launches for f in forms]
    z = fb.fused_attn_block(tx, *params, s, SNH, hd, SWS, shift=shift)
    z.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in forms] == [n0[0] + 1, n0[1] + 1, n0[2], n0[3]]
    plain = [t.detach() for t in params]
    _assert_bf16_close("z", z.detach(),
                       fb.fused_attn_block_bf16_reference(x, *plain, s, SNH, hd, SWS, 1e-5, shift))
    want = fb.fused_attn_block_bwd_bf16_reference(x, *plain, s, dout, SNH, hd, SWS, 1e-5, shift)
    for name, g, wt in zip(ATTN_NAMES, (tx.grad, *(t.grad for t in params)), want):
        assert g.dtype == wt.dtype and g.shape == wt.shape, name
        err, top = (g.float() - wt.float()).abs().max().item(), wt.float().abs().max().item()
        assert err <= BF16_TOL * top, f"{name}: {err:.3g} of {top:.3g}"
    runs = [(fb.fused_attn_block_bf16(x, *plain, s, SNH, hd, SWS, 1e-5, shift),
             *fb.fused_attn_block_backward_bf16(x, *plain, s, dout, SNH, hd, SWS, 1e-5, shift))
            for _ in range(2)]
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)


@pytest.mark.cuda
@pytest.mark.parametrize(("ws", "kinds", "shift"), [(8, 1, 0), (8, 4, 0), (8, 4, WS // 2),
                                                    (12, 4, 0), (12, 4, SWS // 2)])
def test_fused_attn_block_backward_kernel(cuda, ws, kinds, shift):
    """#6 (its tensor-core stages) at SwinIR-M's widths with 8x8 windows and
    SRFormerV2's with 12x12, K=1 and K=4 unshifted and shifted by half the
    window, against its plain version: each gradient within 1e-4 of its
    tensor's largest entry, bit-identical over two runs, one count a call."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    if ws == WS:
        p, nh = _inputs(cuda, kinds), NH
    else:
        p, nh = _ws12_inputs(cuda, kinds), SNH
    args = [p[k] for k in ATTN_NAMES] + [p["s"]]
    meta = (nh, p["x"].shape[-1] // nh, ws, 1e-5, shift)
    dout = torch.randn(p["x"].shape, generator=torch.Generator().manual_seed(12)).to(cuda)
    n0 = fb.fused_attn_block_backward.launches
    grads = fb.fused_attn_block_backward(*args, dout, *meta)
    again = fb.fused_attn_block_backward(*args, dout, *meta)
    torch.cuda.synchronize()
    assert fb.fused_attn_block_backward.launches == n0 + 2
    plain = fb.fused_attn_block_bwd_reference(*args, dout, *meta)
    for name, g, w, g2 in zip(("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias"), grads,
                              plain, again):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_attn_backwards_refuse_what_the_new_plans_do_not_take(cuda):
    """#6 and #10 run their per-token stages on the engine: rows of at most
    256 channels in multiples of 4, each tensor on a 16-byte boundary."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    args = [p[k] for k in ATTN_NAMES] + [p["s"]]
    x = torch.empty(p["x"].numel() + 1, device=cuda)[1:].view(p["x"].shape)
    with pytest.raises(ValueError, match="16-byte"):
        fb.fused_attn_block_backward(x, *args[1:], x, NH, HD, WS)
    P = torch.empty(B, H // WS, W // WS, NH, N, N, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fb.fused_attn_block_train_backward(x, *args[1:7], p["s"], P, p["x"], x, 1, NH, HD, WS)
    # 90 channels, 3 heads of 30: the forward takes them, the backwards do not
    gen = torch.Generator().manual_seed(3)
    c = 90
    ops = [torch.randn(*shape, generator=gen).to(cuda) for shape in (
        (1, 8, 8, c), (c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (1, 3, 64, 64), (1,))]
    assert fb.attn_block_fits(8, 8, WS, c, 3)
    with pytest.raises(ValueError, match="limits"):
        fb.fused_attn_block_backward(*ops, ops[0], 3, 30, WS)


@pytest.mark.cuda
def test_fused_ln_mlp_at_c240_kernels(cuda):
    """#2 and #7 (its two-pass plan) at C 240, hidden 480, against their
    plain versions; #7 bit-identical over two runs."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _ws12_inputs(cuda, 1)
    args = [p[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2")]
    with torch.no_grad():
        got = fb.fused_ln_mlp(*args, p["s"], SWS)
    assert (got - fb.fused_ln_mlp_reference(*args, p["s"], SWS)).abs().max().item() <= TOL
    dout = torch.randn(got.shape, generator=torch.Generator().manual_seed(10)).to(cuda)
    grads = fb.fused_ln_mlp_backward(*args, p["s"], dout, SWS)
    again = fb.fused_ln_mlp_backward(*args, p["s"], dout, SWS)
    torch.cuda.synchronize()
    want = fb.fused_ln_mlp_bwd_reference(*args, p["s"], dout, SWS)
    for i, (g, w, g2) in enumerate(zip(grads, want, again)):
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), i
        assert torch.equal(g, g2), i


@pytest.mark.cuda
def test_staged_shared_memory_plans_match_the_sources(cuda):
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import fused_block as fb

    lib = cuda_build.library("attn_block_staged")
    lib_tr = cuda_build.library("fused_block_train")
    for c, nh, hidden in ((240, 8, 480), (180, 6, 360), (48, 2, 96)):
        for ws in (8, 12):
            assert lib.trr_attn_staged_bwd_smem_bytes(c, nh, ws) == (
                fb.attn_staged_bwd_smem_bytes(c, nh, ws))
            assert lib.trr_attn_train_bwd_smem_bytes(c, nh, ws) == (
                fb.attn_train_bwd_smem_bytes(c, nh, ws))
        assert lib_tr.trr_rows_smem_bytes(c) == fb.rows_smem_bytes(c)
    assert lib_tr.trr_linear_smem_bytes() == fb.linear_smem_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize(("ws", "kinds", "shift"), [(8, 1, 0), (8, 4, WS // 2), (12, 1, 0),
                                                    (12, 4, SWS // 2)])
def test_fused_attn_block_train_kernels(cuda, ws, kinds, shift):
    """#9 (z, P, att) and #10 (dx and the 7 parameter gradients, from the
    same P and att; its window attention the saved-P form of the
    tensor-core kernel) against their plain versions, #10 bit-identical over
    two runs and within 1e-4 of each gradient's largest from the kernel
    forward's own P and att too; the serving form (#1, P not stored) gives
    #9's z bit for bit."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    if ws == WS:
        p, nh = _inputs(cuda, kinds), NH
    else:
        p, nh = _ws12_inputs(cuda, kinds), SNH
    args = [p[k] for k in ATTN_NAMES] + [p["s"]]
    meta = (nh, p["x"].shape[-1] // nh, ws, 1e-5, shift)
    n0 = fb.fused_attn_block_train.launches
    got = fb._attn_block_train_fwd_cuda(*args, *meta)
    with torch.no_grad():
        z = fb.fused_attn_block(*args, *meta[:4], shift=shift)
    torch.cuda.synchronize()
    assert fb.fused_attn_block_train.launches == n0 + 1
    want = fb.fused_attn_block_train_reference(*args, *meta)
    for name, g, w in zip(("z", "P", "att"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL, name
    assert torch.equal(z, got[0])
    dout = torch.randn(z.shape, generator=torch.Generator().manual_seed(11)).to(cuda)
    saved = (*args[:7], p["s"], want[1], want[2], dout, kinds, *meta)
    n0 = fb.fused_attn_block_train_backward.launches
    grads = fb.fused_attn_block_train_backward(*saved)
    again = fb.fused_attn_block_train_backward(*saved)
    torch.cuda.synchronize()
    assert fb.fused_attn_block_train_backward.launches == n0 + 2
    plain = fb.fused_attn_block_train_bwd_reference(*saved)
    chained = fb.fused_attn_block_train_backward(*args[:7], p["s"], got[1], got[2], dout, kinds,
                                                 *meta)
    for name, g, w, g2, g3 in zip(("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias"),
                                  grads, plain, again, chained):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), name
        assert torch.equal(g, g2), name
        assert (g3 - w).abs().max().item() <= TOL * w.abs().max().item(), name


def _bf16_window_case(device, window, kinds, c, nh, shape, seed=0):
    """bf16 qkv and dout, the fp32 kind table of one bf16 window case."""
    from trainner_redux_tpu_torch.ops.window_attention import rect_shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)
    wr, wc = window
    n = wr * wc
    qkv = torch.randn(*shape, 3 * c, generator=gen).to(device).bfloat16()
    rel = (torch.randn(nh, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        masks = torch.from_numpy(rect_shift_mask_kinds(wr, wc, wr // 2, wc // 2)).to(device)
        rel = rel[None] + masks[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(*shape, c, generator=gen).to(device).bfloat16()
    return qkv, rel.contiguous(), dout


# bf16 window cases: (window, C, heads, (B, H, W)): HAT-M's ws 16, SwinIR-L's
# ws 8 at C 240, DAT's rect branches
BF16_WINDOWS = [((16, 16), C, NH, (B, 48, 48)), ((8, 8), 240, 8, (B, 48, 48)),
                ((8, 32), RC, RNH, (B, 64, 64)), ((32, 8), RC, RNH, (B, 64, 64)),
                ((8, 16), RC, RNH, (B, 48, 48))]


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize(("window", "c", "nh", "shape"), BF16_WINDOWS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_bf16_window_attention_kernels(cuda, window, c, nh, shape, kinds):
    """#3's and #8's bf16 forms against their bf16 plain versions, each
    counted once under its own name and none of the fp32 forms; two runs of
    each bit for bit."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _bf16_window_case(cuda, window, kinds, c, nh, shape)
    hd = c // nh
    square = window[0] == window[1]
    win = window[:1] if square else window
    fwd, bwd = ((wa.fused_window_mhsa_bf16, wa.fused_window_mhsa_backward_bf16) if square
                else (wa.fused_rect_mhsa_bf16, wa.fused_rect_mhsa_backward_bf16))
    fp32 = (wa.fused_window_mhsa, wa.fused_window_mhsa_backward, wa.fused_rect_mhsa,
            wa.fused_rect_mhsa_backward)
    n0 = (fwd.launches, bwd.launches, [f.launches for f in fp32])
    tq = qkv.clone().requires_grad_()
    tb = bias.clone().requires_grad_()
    entry = wa.fused_window_mhsa if square else wa.fused_rect_mhsa
    out = entry(tq, tb, nh, hd, *win)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n0[0] + 1, n0[1] + 1)
    assert [f.launches for f in fp32] == n0[2]
    ref = wa.fused_window_mhsa_bf16_reference if square else wa.fused_rect_mhsa_bf16_reference
    bref = (wa.fused_window_mhsa_bwd_bf16_reference if square
            else wa.fused_rect_mhsa_bwd_bf16_reference)
    _assert_bf16_close("out", out.detach(), ref(qkv, bias, nh, hd, *win))
    plain = bref(qkv, bias, dout, nh, hd, *win)
    for name, g, w in zip(("dqkv", "dbias"), (tq.grad, tb.grad), plain):
        assert g.dtype == w.dtype, name
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * w.float().abs().max(), name
    again = (fwd(qkv, bias, nh, hd, *win), *bwd(qkv, bias, dout, nh, hd, *win))
    once = (fwd(qkv, bias, nh, hd, *win), *bwd(qkv, bias, dout, nh, hd, *win))
    for a, b in zip(again, once):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(("c", "hidden"), [(C, HIDDEN), (240, 480)])
def test_bf16_ln_mlp_kernels(cuda, c, hidden):
    """#2's and #7's bf16 forms at HAT-M's MLP half (C 180, hidden 360, 16-row
    strips) and SRFormerV2's (C 240, hidden 480: the 256-column rows tile) on
    bf16 x and dout with fp32 parameters, against their bf16 plain versions
    through the autograd Function, each counted once under its own name;
    two runs bit for bit."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    gen = torch.Generator().manual_seed(c)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x = randn(B, 48, 48, c).bfloat16()
    s = torch.tensor([1.0, 0.8], device=cuda)
    params = [(1.0 + randn(c, scale=0.1)), randn(c, scale=0.1), randn(c, hidden, scale=c**-0.5),
              randn(hidden, scale=0.1), randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1)]
    params = [t.requires_grad_() for t in params]
    dout = randn(B, 48, 48, c).bfloat16()
    tx = x.clone().requires_grad_()
    n0 = (fb.fused_ln_mlp_bf16.launches, fb.fused_ln_mlp_backward_bf16.launches,
          fb.fused_ln_mlp.launches, fb.fused_ln_mlp_backward.launches)
    out = fb.fused_ln_mlp(tx, *params, s, 16)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fb.fused_ln_mlp_bf16.launches, fb.fused_ln_mlp_backward_bf16.launches,
            fb.fused_ln_mlp.launches, fb.fused_ln_mlp_backward.launches) == (
        n0[0] + 1, n0[1] + 1, n0[2], n0[3])
    plain = [t.detach() for t in params]
    _assert_bf16_close("out", out.detach(), fb.fused_ln_mlp_bf16_reference(x, *plain, s, 16))
    want = fb.fused_ln_mlp_bwd_bf16_reference(x, *plain, s, dout, 16)
    for i, (g, w) in enumerate(zip((tx.grad, *(t.grad for t in params)), want)):
        assert g.dtype == w.dtype, i
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * w.float().abs().max(), i
    runs = [(fb.fused_ln_mlp_bf16(x, *plain, s, 16),
             *fb.fused_ln_mlp_backward_bf16(x, *plain, s, dout, 16)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift", "shape"), [(1, 0, (B, H, W)),
                                                       (4, WS // 2, (B, H, W)),
                                                       (4, WS // 2, (1, 16, 40))])
def test_bf16_cos_attn_block_kernels(cuda, kinds, shift, shape):
    """#11's and #12's bf16 forms (bf16 x and dout, fp32 parameters) through
    the autograd Function against their bf16 plain versions, each counted
    once under its own name and no fp32 form launched; (1, 16, 40) leaves a
    ragged last tile of 128 tokens; two runs bit for bit."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, kinds, shape=shape)
    x = p["x"].bfloat16()
    params = [p[k].clone().requires_grad_() for k in COS_NAMES[1:]]
    s = p["s2"]
    dout = torch.randn(*x.shape, generator=torch.Generator().manual_seed(17)).to(cuda).bfloat16()
    meta = (NH, HD, WS, 1e-5, shift)
    forms = (v2.fused_cos_attn_block_bf16, v2.fused_cos_attn_block_backward_bf16,
             v2.fused_cos_attn_block, v2.fused_cos_attn_block_backward)
    n0 = [f.launches for f in forms]
    tx = x.clone().requires_grad_()
    z = v2.fused_cos_attn_block(tx, *params, s, *meta)
    z.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in forms] == [n0[0] + 1, n0[1] + 1, n0[2], n0[3]]
    plain = [t.detach() for t in params]
    _assert_bf16_close("z", z.detach(), v2.fused_cos_attn_block_bf16_reference(x, *plain, s, *meta))
    want = v2.fused_cos_attn_block_bwd_bf16_reference(x, *plain, s, dout, *meta)
    for name, g, wt in zip(COS_NAMES, (tx.grad, *(t.grad for t in params)), want):
        assert g.dtype == wt.dtype and g.shape == wt.shape, name
        err, top = (g.float() - wt.float()).abs().max().item(), wt.float().abs().max().item()
        assert err <= BF16_TOL * top, f"{name}: {err:.3g} of {top:.3g}"
    runs = [(v2.fused_cos_attn_block_bf16(x, *plain, s, *meta),
             *v2.fused_cos_attn_block_backward_bf16(x, *plain, s, dout, *meta)) for _ in range(2)]
    for a, b2 in zip(*runs):
        assert torch.equal(a, b2)


@pytest.mark.cuda
@pytest.mark.parametrize(("c", "hidden"), [(C, HIDDEN), (240, 480), (60, 120)])
def test_bf16_postnorm_mlp_kernels(cuda, c, hidden):
    """#13's and #14's bf16 forms at Swin2SR-M's, -L's and -S's MLP halves
    (bf16 x and dout, fp32 parameters, DropPath scales 0 and 1/0.9) through
    the autograd Function against their bf16 plain versions, each counted
    once under its own name; two runs bit for bit."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    gen = torch.Generator().manual_seed(c + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x = randn(B, 48, 48, c).bfloat16()
    s = torch.tensor([0.0, 1.0 / 0.9], device=cuda)
    params = [randn(c, hidden, scale=c**-0.5), randn(hidden, scale=0.1),
              randn(hidden, c, scale=hidden**-0.5), randn(c, scale=0.1),
              1.0 + randn(c, scale=0.1), randn(c, scale=0.1)]
    params = [t.requires_grad_() for t in params]
    dout = randn(B, 48, 48, c).bfloat16()
    tx = x.clone().requires_grad_()
    forms = (v2.fused_postnorm_mlp_bf16, v2.fused_postnorm_mlp_backward_bf16,
             v2.fused_postnorm_mlp, v2.fused_postnorm_mlp_backward)
    n0 = [f.launches for f in forms]
    out = v2.fused_postnorm_mlp(tx, *params, s, WS)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in forms] == [n0[0] + 1, n0[1] + 1, n0[2], n0[3]]
    plain = [t.detach() for t in params]
    _assert_bf16_close("out", out.detach(), v2.fused_postnorm_mlp_bf16_reference(x, *plain, s, WS))
    want = v2.fused_postnorm_mlp_bwd_bf16_reference(x, *plain, s, dout, WS)
    for i, (g, w) in enumerate(zip((tx.grad, *(t.grad for t in params)), want)):
        assert g.dtype == w.dtype, i
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * w.float().abs().max(), i
    runs = [(v2.fused_postnorm_mlp_bf16(x, *plain, s, WS),
             *v2.fused_postnorm_mlp_backward_bf16(x, *plain, s, dout, WS)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_postnorm_forms_refuse_what_they_do_not_take(cuda):
    """A bf16 x outside the bf16 forms' gates raises, naming the form's
    limits, and launches nothing: rows of 264 channels (past the bf16
    engine's 256), and an fp32 parameter where the form takes bf16 x with a
    bf16 dout; the shared-memory plans are the sources'."""
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    forms = (v2.fused_cos_attn_block_bf16, v2.fused_cos_attn_block_backward_bf16,
             v2.fused_postnorm_mlp_bf16, v2.fused_postnorm_mlp_backward_bf16)
    n0 = [f.launches for f in forms]
    c, nh = 264, 12
    x = torch.zeros(1, 16, 16, c, device=cuda, dtype=torch.bfloat16)
    cos = [torch.zeros(c, 3 * c, device=cuda), torch.zeros(3 * c, device=cuda),
           torch.ones(nh, device=cuda), torch.zeros(c, c, device=cuda),
           *(torch.zeros(c, device=cuda) for _ in range(3)),
           torch.zeros(1, nh, N, N, device=cuda)]
    with pytest.raises(ValueError, match="bf16 form's limits"), torch.no_grad():
        v2.fused_cos_attn_block(x, *cos, torch.ones(1, device=cuda), nh, c // nh, WS)
    mlp = [torch.zeros(c, 2 * c, device=cuda), torch.zeros(2 * c, device=cuda),
           torch.zeros(2 * c, c, device=cuda), *(torch.zeros(c, device=cuda) for _ in range(3))]
    with pytest.raises(ValueError, match="bf16 form's limits"), torch.no_grad():
        v2.fused_postnorm_mlp(x, *mlp, torch.ones(1, device=cuda), WS)
    p = _v2_inputs(cuda, 1)
    ops = [p[k] for k in COS_NAMES]
    with pytest.raises(TypeError, match="bfloat16"):  # dout fp32 beside a bf16 x
        v2.fused_cos_attn_block_backward_bf16(ops[0].bfloat16(), *ops[1:], p["s2"], ops[0],
                                              NH, HD, WS)
    assert [f.launches for f in forms] == n0
    lib_v2, lib_tr = cuda_build.library("fused_block_v2"), cuda_build.library("fused_block_train")
    for c, hidden in ((180, 360), (240, 480), (60, 120)):
        assert max(lib_v2.trr_cos_attn_bf16_smem_bytes(c), lib_tr.trr_atb_bf16_smem_bytes()) == (
            v2.cos_attn_bf16_smem_bytes(c))
        assert max(lib_v2.trr_pn_mlp_bf16_smem_bytes(c, hidden),
                   lib_tr.trr_atb_bf16_smem_bytes()) == v2.pn_mlp_bf16_smem_bytes(c, hidden)


# #3/#8's 64-wide form: (window, C, heads, (B, H, W)): ATD's training block
# (C 210, heads of 35: a head every 35 elements of a qkv row), heads of 64
# (C 384), heads of 35 at 8x8 windows and at dat_s's 8x16 rectangles
HD64_WINDOWS = [((16, 16), 210, 6, (B, 48, 48)), ((16, 16), 384, 6, (B, 32, 48)),
                ((8, 8), 210, 6, (B, 32, 48)), ((8, 16), 105, 3, (B, 32, 48))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize(("window", "c", "nh", "shape"), HD64_WINDOWS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_hd64_window_attention_kernels(cuda, window, c, nh, shape, kinds, dtype):
    """#3 and #8 at heads of 33 to 64 channels (rows padded to 64) against
    their plain versions through the autograd Functions, fp32 within TOL
    and bf16 as the 32-wide bf16 forms are held; each counted once under
    its own name; two runs bit for bit."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _bf16_window_case(cuda, window, kinds, c, nh, shape, seed=c + kinds)
    bf16 = dtype == "bf16"
    if not bf16:
        qkv, dout = qkv.float(), dout.float()
    hd = c // nh
    assert 32 < hd <= 64 and wa.rect_mhsa_fits(*shape[1:], *window, c, nh)
    square = window[0] == window[1]
    win = window[:1] if square else window
    if square:
        fwd, bwd = ((wa.fused_window_mhsa_bf16, wa.fused_window_mhsa_backward_bf16) if bf16
                    else (wa.fused_window_mhsa, wa.fused_window_mhsa_backward))
        entry = wa.fused_window_mhsa
        ref = wa.fused_window_mhsa_bf16_reference if bf16 else wa.fused_window_mhsa_reference
        bref = (wa.fused_window_mhsa_bwd_bf16_reference if bf16
                else wa.fused_window_mhsa_bwd_reference)
    else:
        fwd, bwd = ((wa.fused_rect_mhsa_bf16, wa.fused_rect_mhsa_backward_bf16) if bf16
                    else (wa.fused_rect_mhsa, wa.fused_rect_mhsa_backward))
        entry = wa.fused_rect_mhsa
        ref = wa.fused_rect_mhsa_bf16_reference if bf16 else wa.fused_rect_mhsa_reference
        bref = (wa.fused_rect_mhsa_bwd_bf16_reference if bf16
                else wa.fused_rect_mhsa_bwd_reference)
    n0 = (fwd.launches, bwd.launches)
    tq = qkv.clone().requires_grad_()
    tb = bias.clone().requires_grad_()
    out = entry(tq, tb, nh, hd, *win)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n0[0] + 1, n0[1] + 1)
    want = ref(qkv, bias, nh, hd, *win)
    if bf16:
        _assert_bf16_close("out", out.detach(), want)
    else:
        assert (out.detach() - want).abs().max().item() <= TOL
    tol = BF16_TOL if bf16 else TOL
    for name, g, w in zip(("dqkv", "dbias"), (tq.grad, tb.grad),
                          bref(qkv, bias, dout, nh, hd, *win)):
        assert g.dtype == w.dtype, name
        assert (g.float() - w.float()).abs().max().item() <= tol * w.float().abs().max(), name
    with torch.no_grad():
        runs = [(entry(qkv, bias, nh, hd, *win), *bwd(qkv, bias, dout, nh, hd, *win))
                for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hd64_shared_memory_plans_match_the_source(cuda):
    """The 64-wide plans, the source's and the Python side's, at heads of 35
    and 64 in every window form; a head of 65 has none."""
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import window_attention as wa

    lib = cuda_build.library("window_attention")
    for c, nh in ((210, 6), (384, 6), (105, 3)):
        for window in list(RECT) + [(8, 8), (16, 16)]:
            assert lib.trr_rect_mhsa_smem_bytes(c, nh, *window) == wa.rect_mhsa_smem_bytes(
                c, nh, *window) <= wa.SMEM_LIMIT
            assert lib.trr_rect_mhsa_bwd_smem_bytes(c, nh, *window) == (
                wa.rect_mhsa_bwd_smem_bytes(c, nh, *window)) <= wa.SMEM_LIMIT
    assert lib.trr_rect_mhsa_smem_bytes(390, 6, 16, 16) == 0


@pytest.mark.cuda
def test_hd64_wrappers_refuse_heads_past_64(cuda):
    """Heads of 65 channels are outside every form: a bf16 or fp32 qkv
    raises, naming the limits, and nothing launches or falls back."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _bf16_window_case(cuda, (16, 16), 1, 390, 6, (1, 32, 32))
    forms = (wa.fused_window_mhsa, wa.fused_window_mhsa_bf16, wa.fused_window_mhsa_backward,
             wa.fused_window_mhsa_backward_bf16)
    n0 = [f.launches for f in forms]
    with pytest.raises(ValueError, match="at most 64 channels"), torch.no_grad():
        wa.fused_window_mhsa(qkv, bias, 6, 65, 16)
    with pytest.raises(ValueError, match="at most 64 channels"):
        wa.fused_window_mhsa_backward(qkv.float(), bias, dout.float(), 6, 65, 16)
    assert [f.launches for f in forms] == n0
