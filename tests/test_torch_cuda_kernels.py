"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks its fixture for a card and skips without
one (here on the CPU they skip). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

Shapes are SwinIR-M's (C=180, 6 heads of 30, window 8, hidden 360) at a
64x96 map and batch 2, unit-scale fp32 inputs, tolerance 1e-4 (the kernels
sum in another order than cuBLAS).
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


def _inputs(device, kinds, seed=0):
    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    gen = torch.Generator().manual_seed(seed)

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
    }
    rel = randn(NH, N, N, scale=0.5)
    if kinds == 4:
        rel = rel[None] + torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(device)[:, None]
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
    lib_wa = cuda_build.library("window_attention")
    for c, nh, hidden in ((180, 6, 360), (240, 8, 480), (60, 6, 120)):
        assert lib_fb.trr_attn_block_smem_bytes(c, nh) == fb.attn_block_smem_bytes(c, nh)
        assert lib_fb.trr_ln_mlp_smem_bytes(c, hidden) == fb.ln_mlp_smem_bytes(c, hidden)
        assert lib_wa.trr_window_mhsa_smem_bytes(c, nh) == wa.window_mhsa_smem_bytes(c, nh)


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
