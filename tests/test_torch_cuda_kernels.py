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
within 1e-4 of each tensor's largest magnitude.
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


def _inputs(device, kinds, seed=0, ws=WS):
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)
    n = ws * ws

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    p = {
        "x": randn(B, H, W, C), "qkv": randn(B, H, W, 3 * C),
        "g": 1.0 + randn(C, scale=0.1), "be": randn(C, scale=0.1),
        "wq": randn(C, 3 * C, scale=C**-0.5), "bq": randn(3 * C, scale=0.1),
        "wp": randn(C, C, scale=C**-0.5), "bp": randn(C, scale=0.1),
        "w1": randn(C, HIDDEN, scale=C**-0.5), "b1": randn(HIDDEN, scale=0.1),
        "w2": randn(HIDDEN, C, scale=HIDDEN**-0.5), "b2": randn(C, scale=0.1),
        "s": torch.tensor([1.0, 0.8], device=device),
        "g2": 1.0 + randn(C, scale=0.1), "be2": randn(C, scale=0.1),
        "s2": torch.tensor([0.0, 1.0 / 0.9], device=device),
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
    for c, nh, hidden in ((180, 6, 360), (240, 8, 480), (60, 6, 120)):
        assert lib_fb.trr_attn_block_smem_bytes(c, nh) == fb.attn_block_smem_bytes(c, nh)
        assert lib_fb.trr_ln_mlp_smem_bytes(c, hidden) == fb.ln_mlp_smem_bytes(c, hidden)
        for ws in (8, 16):
            assert lib_wa.trr_window_mhsa_smem_bytes(c, nh, ws) == wa.window_mhsa_smem_bytes(
                c, nh, ws)
            assert lib_wa.trr_window_mhsa_bwd_smem_bytes(c, nh, ws) == (
                wa.window_mhsa_bwd_smem_bytes(c, nh, ws))
        assert lib_tr.trr_bwd_tokens_smem_bytes(c, hidden) == fb.bwd_tokens_smem_bytes(c, hidden)
        assert lib_tr.trr_bwd_attn_smem_bytes(c, nh) == fb.bwd_attn_smem_bytes(c, nh)
        assert lib_tr.trr_bwd_ln1_smem_bytes(c) == fb.bwd_ln1_smem_bytes(c)


TRAIN_NAMES = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2",
               "b2")


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift"), [(1, 0), (4, WS // 2)])
def test_swin_block_train_kernels(cuda, kinds, shift):
    """#4 (out, P, att, z) and #5 (dx and the 13 parameter gradients)
    against their plain versions."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, kinds)
    ops = [p[k] for k in TRAIN_NAMES]
    meta = (NH, HD, WS, 1e-5, shift)
    got = fb._swin_block_train_fwd_cuda(*ops, p["s"], p["s2"], *meta)
    want = fb.fused_swin_block_train_reference(*ops, p["s"], p["s2"], *meta)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "P", "att", "z"), got, want):
        assert (g - w).abs().max().item() <= TOL, name
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
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
    """#1 has no CUDA backward yet (#6): under autograd it raises instead of
    returning a tensor that carries no gradient; under no_grad it runs."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    wq = p["wq"].clone().requires_grad_()
    attn = [p[k] for k in ("x", "g", "be")] + [wq] + [p[k] for k in ("bq", "wp", "bp", "bias", "s")]
    with pytest.raises(RuntimeError, match="#6"):
        fb.fused_attn_block(*attn, NH, HD, WS)
    with torch.no_grad():
        fb.fused_attn_block(*attn, NH, HD, WS)


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
    also on a ragged last tile of tokens."""
    from trainner_redux_tpu_torch.ops import fused_block as fb

    p = _inputs(cuda, 1)
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    gen = torch.Generator().manual_seed(8)
    for x, s in ((p["x"], p["s2"]), (torch.randn(1, 8, 12, C, generator=gen).to(cuda),
                                     torch.ones(1, device=cuda))):
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


def _v2_inputs(device, kinds, seed=0):
    """SwinIR-M-wide inputs plus the temperatures exp(min(logit, log 100)),
    between 1 and 100, that the cosine attention takes."""
    p = _inputs(device, kinds, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    p["scale"] = torch.exp(torch.rand(NH, generator=gen) * 4.6).to(device)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize(("kinds", "shift"), [(1, 0), (4, 0), (4, WS // 2)])
def test_fused_cos_attn_block_kernels(cuda, kinds, shift):
    """#11 (z) and #12 (dx and the eight parameter gradients) against their
    plain versions."""
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, kinds)
    ops = [p[k] for k in COS_NAMES]
    meta = (NH, HD, WS, 1e-5, shift)
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
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
def test_postnorm_backwards_are_deterministic(cuda):
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    p = _v2_inputs(cuda, 4)
    dout = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(7)).to(cuda)
    cos = [p[k] for k in COS_NAMES]
    mlp = [p[k] for k in PN_NAMES]
    for fn in (lambda: v2.fused_cos_attn_block_backward(*cos, p["s2"], dout, NH, HD, WS,
                                                        shift=WS // 2),
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
    with pytest.raises(ValueError, match="limits"):  # Swin2SR-L's MLP backward: no room
        x = torch.zeros(1, 8, 8, 240, device=cuda)
        w1, w2 = torch.zeros(240, 480, device=cuda), torch.zeros(480, 240, device=cuda)
        v2.fused_postnorm_mlp_backward(x, w1, torch.zeros(480, device=cuda), w2,
                                       *(torch.zeros(240, device=cuda) for _ in range(3)),
                                       torch.ones(1, device=cuda), x, WS)


@pytest.mark.cuda
def test_postnorm_shared_memory_plans_match_the_source(cuda):
    from trainner_redux_tpu_torch.ops import cuda_build
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    lib = cuda_build.library("fused_block_v2")
    for c, nh, hidden in ((180, 6, 360), (240, 8, 480), (60, 6, 120)):
        assert lib.trr_cos_attn_fwd_smem_bytes(c, nh) == v2.cos_attn_fwd_smem_bytes(c, nh)
        assert lib.trr_pn_mlp_fwd_smem_bytes(c, hidden) == v2.pn_mlp_fwd_smem_bytes(c, hidden)
        assert lib.trr_postnorm_ln_bwd_smem_bytes(c) == v2.postnorm_ln_bwd_smem_bytes(c)
        assert lib.trr_cos_attn_bwd_smem_bytes(c // nh) == v2.cos_attn_bwd_smem_bytes(c // nh)
        assert lib.trr_qkv_dx_smem_bytes(c) == v2.qkv_dx_smem_bytes(c)
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
