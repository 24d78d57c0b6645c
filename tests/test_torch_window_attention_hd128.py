"""The window attention (TPU kernels #3 and #8) at heads of 65 to 128
channels (the kernels' 128-wide form, DRCT's heads of 122 and 77), on the
CPU, where the port's wrappers run their plain versions:

- the plain versions against the JAX package's Pallas kernels in interpret
  mode through `jax.vjp`, at heads of 122 and 77 at 16x16 windows (B=1,
  32x32, 2 heads) and of 122 at 8x8 (B=1, 16x16, 2 heads), K=1 unshifted
  and K=4 with the shift masks: in fp32 the output and dqkv / dbias within
  1e-4 of each largest; in bf16 (qkv and dout rounded to bf16, the kind
  table fp32; heads of 122 at K=4, of 77 at K=1) by
  tests/test_torch_bf16_window_mlp.py's rule;
- #3's 128-wide schedule, blocked as its kernel blocks it (row blocks of
  `TC_ATTN_FWD_PLAN_128`, S a key tile at a time over the head's 8-channel
  k-steps into a (rows, n) tile over the bias rows, the exact softmax of
  whole rows, P v summed tile by tile), in PyTorch against the JAX
  package's window MHSA (its plain reference at square windows, the Pallas
  kernel in interpret mode at 8x16 rectangles) at heads of 77, 122 and 128 and
  windows of 64, 128 and 256 tokens, K=1 and K=4: the output within 1e-4
  of its largest;
- #8's 128-wide schedule, blocked as its kernels block it (a row pass over
  row blocks, S and dP summed over two 64-channel halves, dS and each row's
  max and inverse sum saved; a key pass over key blocks and row blocks, P
  recomputed from them), in PyTorch against `jax.vjp` of the JAX package's
  window MHSA (its plain reference at square windows, the Pallas kernel in
  interpret mode at 8x16 rectangles) at heads of 77, 122 and 128 and
  windows of 64, 128 and 256 tokens, K=1 and K=4: dqkv and dbias within
  1e-4 of each largest;
- the gates: `window_mhsa_fits` and `rect_mhsa_fits` take heads of 65 to
  128 channels and not 129, on the 128-wide plans (the forward's
  `TC_ATTN_FWD_PLAN_128`: two buffers of a key tile's whole head rows;
  #8's row pass `TC_ATTN_PLANS_128`: one (n, 68) room for a half of k or
  v; its key pass `TC_ATTN_KEY_PLAN_128`), while `heads_fit`, the block
  kernels' gate, stays at 32;
- the routing: every preset the port had before this form has heads of at
  most 64 channels (SRFormer's here; the others in
  tests/test_torch_window_attention_hd64.py), so none changes branch; every
  attention of `drct`, `drct_l` and `drct_xl` (heads of 30, 53, 122, 46
  and 77) takes the kernels at the templates' 48x48 crops and at a 128x128
  image.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_window_mlp import _assert_grad_close, _assert_out_close, _bf16
from tests.test_torch_window_attention_hd64 import _head_dims
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.ops.pallas import window_attention as jwa
from trainner_redux_tpu_torch.ops import window_attention as twa

TOL = 1e-4  # of each tensor's largest magnitude
NH = 2
# (window size, head dim) -> (B, H, W)
CASES = {(16, 122): (1, 32, 32), (16, 77): (1, 32, 32), (8, 122): (1, 16, 16)}


def _vjp(fn, qkv, bias, dout):
    """(out, *grads) of `fn` (a window MHSA of (qkv, bias)) through jax.vjp
    for the output gradient dout."""
    out, vjp = jax.vjp(fn, qkv, bias)
    return (out, *vjp(dout))


@functools.cache
def _jax_vjp(fn):
    """`_vjp` of `fn` jitted, once for each shape (K=1 and K=4 share the
    compiled function); fp32 only: jitted whole, XLA on the CPU may keep
    fp32 where an eager bf16 run rounds."""
    return jax.jit(functools.partial(_vjp, fn))


@functools.cache
def _window_mhsa(hd: int, ws: int):
    """The JAX package's fused_window_mhsa, the Pallas kernel in interpret
    mode, at NH heads of hd channels."""
    return lambda q, t: jwa.fused_window_mhsa(q, t, NH, hd, ws, True)


def _inputs(ws: int, hd: int, kinds: int, bf16: bool):
    b, hh, ww = CASES[ws, hd]
    rng = np.random.default_rng(ws * 1000 + hd + kinds)
    c = NH * hd
    qkv = rng.standard_normal((b, hh, ww, 3 * c)).astype(np.float32)
    rel = (rng.standard_normal((NH, ws * ws, ws * ws)) * 0.3).astype(np.float32)
    masks = jwa.shift_mask_kinds(ws, ws // 2)[:, None] if kinds == 4 else 0.0
    bias = np.ascontiguousarray(rel[None] + masks, dtype=np.float32)
    dout = rng.standard_normal((b, hh, ww, c)).astype(np.float32)
    if bf16:
        qkv, dout = _bf16(qkv), _bf16(dout)
    return qkv, bias, dout


@pytest.mark.parametrize(("ws", "hd", "kinds", "dtype"), [
    *((ws, hd, kinds, "fp32") for ws, hd in CASES for kinds in (1, 4)),
    (16, 122, 4, "bf16"), (16, 77, 1, "bf16")])
def test_hd128_plain_versions_match_jax_vjp(ws, hd, kinds, dtype):
    bf16 = dtype == "bf16"
    qkv, bias, dout = _inputs(ws, hd, kinds, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    run = functools.partial(_vjp, _window_mhsa(hd, ws)) if bf16 else _jax_vjp(_window_mhsa(hd, ws))
    want, want_dqkv, want_dbias = (np.asarray(g, np.float32) for g in run(
        jnp.asarray(qkv, jdt), jnp.asarray(bias), jnp.asarray(dout, jdt)))

    tdt = torch.bfloat16 if bf16 else torch.float32
    tq = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    assert twa.window_mhsa_fits(*qkv.shape[1:3], ws, NH * hd, NH) and twa.head_width(hd) == 128
    counted = (twa.fused_window_mhsa, twa.fused_window_mhsa_backward,
               twa.fused_window_mhsa_bf16, twa.fused_window_mhsa_backward_bf16)
    launches = [(f.launches, f.launches_hd128) for f in counted]
    out = twa.fused_window_mhsa(tq, tb, NH, hd, ws)
    out.backward(torch.from_numpy(dout).to(tdt))
    # CPU: the plain versions, uncounted
    assert launches == [(f.launches, f.launches_hd128) for f in counted]
    assert out.dtype == tq.grad.dtype == tdt and tb.grad.dtype == torch.float32
    got = (out.detach().float().numpy(), tq.grad.float().numpy(), tb.grad.numpy())
    if bf16:
        _assert_out_close("out", got[0], want)
        _assert_grad_close("dqkv", got[1], want_dqkv)
        _assert_grad_close("dbias", got[2], want_dbias)
        return
    for name, g, w in zip(("out", "dqkv", "dbias"), got, (want, want_dqkv, want_dbias)):
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= TOL * top, f"{name}: max|diff| {err:.3g} vs max {top:.3g}"


# #8's blocked schedule: (head dim, window (rows, columns)) -> map (H, W),
# two windows a side (K=4: every kind once), B=1, two heads
BLOCKED = {(hd, win): (2 * win[0], 2 * win[1]) for hd in (77, 122, 128)
           for win in ((8, 8), (8, 16), (16, 16))}


def _blocked_wide_bwd(qkv, bias, dout, num_heads, head_dim, wr, wc):
    """(dqkv, dbias) of the window MHSA as the 128-wide #8's two kernels
    block it, in fp32: the row pass over row blocks (`tc_attn_plan`), S and
    dP summed over the head's two 64-channel halves, the softmax's max and
    inverse sum kept for each row, dS kept, dQ = scale dS k a half at a
    time; then the key pass over key blocks and, in each, row blocks
    (`TC_ATTN_KEY_PLAN_128`), P recomputed from S, the bias and the kept
    stats, dV = P^T dA and dK = scale dS^T q summed over the row blocks;
    dbias the kept dS summed over the windows by kind."""
    b, hh, ww, _ = qkv.shape
    n, scale = wr * wc, head_dim**-0.5
    q, k, v = (twa._window_heads(t, num_heads, wr, wc) for t in qkv.chunk(3, dim=-1))
    da = twa._window_heads(dout, num_heads, wr, wc)
    kind = twa.window_kinds(hh // wr, ww // wc, bias.shape[0])
    table = bias[kind]  # (windows, heads, n, n)
    halves = (slice(0, 64), slice(64, head_dim))
    rb, _ = twa.tc_attn_plan(n, head_dim)
    kb, r, _ = twa.TC_ATTN_KEY_PLAN_128
    ds = torch.empty(*q.shape[:-1], n)
    m, inv = (torch.empty(*q.shape[:-1], 1) for _ in range(2))
    dq = torch.empty_like(q)
    for r0 in range(0, n, rb):  # the row pass
        rows = slice(r0, r0 + rb)
        s = sum(q[..., rows, c] @ k[..., c].transpose(-1, -2) for c in halves)
        s = s * scale + table[:, :, rows]
        m[..., rows, :] = s.amax(-1, keepdim=True)
        e = torch.exp(s - m[..., rows, :])
        inv[..., rows, :] = 1 / e.sum(-1, keepdim=True)
        p = e * inv[..., rows, :]
        dp = sum(da[..., rows, c] @ v[..., c].transpose(-1, -2) for c in halves)
        ds[..., rows, :] = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[..., rows, :] = torch.cat([ds[..., rows, :] @ k[..., c] for c in halves], -1) * scale
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, n, kb):  # the key pass
        keys = slice(k0, k0 + kb)
        dk_sum, dv_sum = torch.zeros_like(k[..., keys, :]), torch.zeros_like(v[..., keys, :])
        for r0 in range(0, n, r):
            rows = slice(r0, r0 + r)
            s = q[..., rows, :] @ k[..., keys, :].transpose(-1, -2) * scale
            p = torch.exp(s + table[:, :, rows, keys] - m[..., rows, :]) * inv[..., rows, :]
            dv_sum += p.transpose(-1, -2) @ da[..., rows, :]
            dk_sum += ds[..., rows, keys].transpose(-1, -2) @ q[..., rows, :]
        dk[..., keys, :], dv[..., keys, :] = dk_sum * scale, dv_sum
    dbias = torch.zeros(bias.shape).index_add_(0, kind, ds.sum(0))
    dqkv = torch.cat([t.transpose(2, 3).flatten(-2) for t in (dq, dk, dv)], dim=-1)
    return twa.rect_reverse(dqkv, hh, ww, wr, wc), dbias


def _blocked_wide_fwd(qkv, bias, num_heads, head_dim, wr, wc):
    """The window MHSA as the 128-wide #3's kernel blocks it, in fp32: row
    blocks of `TC_ATTN_FWD_PLAN_128`'s rows; per row block, S = q k^T a key
    tile at a time, summed over the head's channels in k-steps of 8 (the
    last zero past the head), scaled and added to the block's bias rows in
    a (rows, n) tile; the softmax of whole rows (max, exp, sum, times the
    inverse sum); att = P v summed over the key tiles in order. (On the
    card a head row may sit a few channels into its first k-step, where
    the copies start; zeros fill the rest, so only the sums' order moves.)"""
    _, hh, ww, _ = qkv.shape
    n, scale = wr * wc, head_dim**-0.5
    q, k, v = (twa._window_heads(t, num_heads, wr, wc) for t in qkv.chunk(3, dim=-1))
    table = bias[twa.window_kinds(hh // wr, ww // wc, bias.shape[0])]  # (windows, heads, n, n)
    rb, kt = twa.TC_ATTN_FWD_PLAN_128
    steps = [slice(c, c + 8) for c in range(0, head_dim, 8)]
    out = torch.empty_like(q)
    for r0 in range(0, n, rb):
        rows = slice(r0, r0 + rb)
        s = table[:, :, rows].clone().expand(*q.shape[:3], rb, n).clone()
        for k0 in range(0, n, kt):
            keys = slice(k0, k0 + kt)
            prod = sum(q[..., rows, c] @ k[..., keys, c].transpose(-1, -2) for c in steps)
            s[..., keys] = prod * scale + s[..., keys]
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e * (1 / e.sum(-1, keepdim=True))
        out[..., rows, :] = sum(p[..., k0:k0 + kt] @ v[..., k0:k0 + kt, :]
                                for k0 in range(0, n, kt))
    return twa.rect_reverse(out.transpose(2, 3).flatten(-2), hh, ww, wr, wc)


@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize(("hd", "win"), list(BLOCKED),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_blocked_wide_forward_matches_jax(hd, win, kinds):
    wr, wc = win
    qkv, bias, dout = _blocked_inputs(hd, win, kinds)
    want = _jax_window_vjp(hd, win, kinds, qkv, bias, dout)[0]
    got = _blocked_wide_fwd(torch.from_numpy(qkv), torch.from_numpy(bias), NH, hd, wr, wc)
    err, top = np.abs(got.numpy() - want).max(), np.abs(want).max()
    assert err <= TOL * top, f"out: max|diff| {err:.3g} vs max {top:.3g}"


@functools.cache
def _reference(hd: int, ws: int):
    """The JAX package's plain window MHSA (a table a window)."""
    return lambda q, t: jwa.reference_window_mhsa(q, t, NH, hd, ws)


@functools.cache
def _rect_mhsa(hd: int, wr: int, wc: int):
    """The JAX package's fused_rect_mhsa, the Pallas kernel in interpret
    mode."""
    return lambda q, t: jwa.fused_rect_mhsa(q, t, NH, hd, wr, wc, True)


def _blocked_inputs(hd: int, win: tuple[int, int], kinds: int):
    """qkv, the kind table and dout of a `BLOCKED` case, from its seed."""
    wr, wc = win
    hh, ww = BLOCKED[hd, win]
    rng = np.random.default_rng(hd + 7 * wr + wc + kinds)
    c, n = NH * hd, wr * wc
    qkv = rng.standard_normal((1, hh, ww, 3 * c)).astype(np.float32)
    rel = (rng.standard_normal((NH, n, n)) * 0.3).astype(np.float32)
    masks = jwa.rect_shift_mask_kinds(wr, wc, wr // 2, wc // 2)[:, None] if kinds == 4 else 0.0
    bias = np.ascontiguousarray(rel[None] + masks, dtype=np.float32)
    dout = rng.standard_normal((1, hh, ww, c)).astype(np.float32)
    return qkv, bias, dout


def _jax_window_vjp(hd, win, kinds, qkv, bias, dout):
    """(out, dqkv, dbias) of the JAX package's window MHSA through jax.vjp:
    its plain reference on each window's table at square windows, the
    Pallas kernel in interpret mode at rectangles (jitted once a shape)."""
    wr, wc = win
    hh, ww = qkv.shape[1:3]
    if wr == wc:
        kind = np.asarray(twa.window_kinds(hh // wr, ww // wc, kinds))
        out, dqkv, per_window = (np.asarray(g) for g in _jax_vjp(_reference(hd, wr))(
            jnp.asarray(qkv), jnp.asarray(bias[kind]), jnp.asarray(dout)))
        dbias = np.zeros_like(bias)
        np.add.at(dbias, kind, per_window)
        return out, dqkv, dbias
    return tuple(np.asarray(g) for g in _jax_vjp(_rect_mhsa(hd, wr, wc))(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(dout)))


@pytest.mark.parametrize("kinds", [1, 4])
@pytest.mark.parametrize(("hd", "win"), list(BLOCKED),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_blocked_wide_schedule_matches_jax_vjp(hd, win, kinds):
    wr, wc = win
    qkv, bias, dout = _blocked_inputs(hd, win, kinds)
    _, want_dqkv, want_dbias = _jax_window_vjp(hd, win, kinds, qkv, bias, dout)
    got = _blocked_wide_bwd(*(torch.from_numpy(a) for a in (qkv, bias, dout)), NH, hd, wr, wc)
    for name, g, w in zip(("dqkv", "dbias"), got, (want_dqkv, want_dbias)):
        err, top = np.abs(g.numpy() - w).max(), np.abs(w).max()
        assert err <= TOL * top, f"{name}: max|diff| {err:.3g} vs max {top:.3g}"


def test_gates_take_heads_of_up_to_128():
    for hd in list(range(60, 70)) + list(range(120, 134)):
        c = 2 * hd
        assert twa.window_mhsa_fits(48, 48, 16, c, 2) == (hd <= 128), hd
        assert twa.window_mhsa_fits(64, 64, 8, c, 2) == (hd <= 128), hd
        for window in ((8, 32), (32, 8), (8, 16), (16, 8)):
            assert twa.rect_mhsa_fits(64, 64, *window, c, 2) == (hd <= 128), (hd, window)
        assert not twa.heads_fit(8, c, 2)  # the block kernels keep 32
        assert twa.head_width(hd) == (64 if hd <= 64 else 128 if hd <= 128 else twa.HD_MAX)
    assert twa.fused_window_mhsa_supported(48, 48, 16, 244, 2)  # drct's swin_3
    assert twa.fused_window_mhsa_supported(48, 48, 16, 308, 4)  # drct's swin_5


def test_hd128_plans():
    """The 128-wide plans: a whole 128-wide head's k and v would need
    270,336 B at n 256. The forward streams them in tiles of 64 keys, a
    block per row block of 64 (two buffers of whole head rows beside the
    (64, n + 4) S / P tile: 135,168 B at n 256 in fp32, one block a SM;
    102,400 B in bf16, two); #8's row pass on rows of 64 in two key parts
    (one (n, 68) room for a half of k or v, 190,976 B at n 256); its key pass
    on blocks of 64 keys whose whole k rows stay staged, rows of 32 in four
    key parts (86,016 B at n 256, two blocks a SM); the backward's size the
    larger of its passes'; the 32- and 64-wide plans unchanged."""
    assert 4 * 2 * 256 * (128 + 4) == 270_336 > twa.SMEM_LIMIT
    assert twa.tc_attn_plan(256, 122) == twa.tc_attn_plan(64, 77) == (64, 2)
    assert twa.tc_attn_plan(256, 35) == (32, 4)
    assert twa.tc_attn_plan(256, 30) == (64, 4)
    assert twa.TC_ATTN_KEY_PLAN_128 == (64, 32, 4)
    assert twa.TC_ATTN_FWD_PLAN_128 == (64, 64)
    assert twa.window_mhsa_smem_bytes(244, 2, 16) == twa.wide_fwd_smem_bytes(256) == 135_168
    assert twa.wide_fwd_smem_bytes(256, bf16=True) == 102_400
    assert twa.wide_bwd_smem_bytes(256) == (190_976, 86_016)
    assert twa.window_mhsa_bwd_smem_bytes(244, 2, 16) == 190_976
    assert twa.window_mhsa_smem_bytes(210, 6, 16) == 192_000  # ATD's, as before
    assert twa.window_mhsa_smem_bytes(180, 6, 16) == 161_792  # HAT-M's, as before
    for n in (64, 128, 256):
        rows, keys = twa.wide_bwd_smem_bytes(n)
        assert max(twa.attn_fwd_tc_smem_bytes(n, 122), rows) <= twa.SMEM_LIMIT
        assert twa.attn_bwd_tc_smem_bytes(n, att=False, head_dim=77) == rows > keys
        assert 2 * (keys + 1024) <= 233_472  # two key-pass blocks a SM
        for bf16, blocks in twa.WIDE_FWD_BLOCKS.items():  # the forward's blocks a SM fit
            assert blocks * (twa.wide_fwd_smem_bytes(n, bf16) + 1024) <= 233_472
    assert 2 * (twa.wide_fwd_smem_bytes(256) + 1024) > 233_472  # hence one fp32 block a SM


@pytest.mark.parametrize("preset", ["srformer", "srformer_light"])
def test_routing_of_the_ported_presets_is_unchanged(preset):
    """Only heads of 65 to 128 channels see the wider gate: no preset ported
    before has them (the presets before ATD and ATD's own are held by
    tests/test_torch_window_attention_hd64.py's routing test, at most 32 and
    35 channels; SRFormer's here)."""
    dims = _head_dims(preset)
    assert dims and max(dims) <= 64, (preset, dims)


@pytest.mark.parametrize("preset", ["drct", "drct_l", "drct_xl"])
def test_drct_attentions_take_the_kernels(preset):
    dims = _head_dims(preset)
    assert dims == {30, 53, 122, 46, 77}
    for c, nh in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        assert twa.fused_window_mhsa_supported(48, 48, 16, c, nh)
        assert twa.fused_window_mhsa_supported(128, 128, 16, c, nh)
