"""bf16 training on the port against the JAX package, on the CPU (the port's
kernel wrappers run their bf16 plain versions; the JAX package runs its
Pallas kernels in interpret mode in bf16, TRAINNER_FUSED_BLOCK=interpret):

- a tiny SwinIR (embed 32, 2 groups x 2 blocks, 2 heads of 16, window 8,
  2x, batch 2 of 16x16 LR) computing in bf16 in training against the flax
  SwinIR built with dtype=bfloat16 (train=True), from equal parameters
  through `state_dict_from_jax`: the output within 2e-2 of its largest
  magnitude (a bf16 step is 3.9e-3 of it; four transformer blocks and six
  convolutions round between them, and XLA's CPU lowering may keep an fp32
  result where the flax graph writes a bf16 one). The parameter gradients
  sum bf16-rounded gradients of random sign over every pixel, so bf16 moves
  each, in either package, some 3-17% of its largest magnitude from its
  fp32 value: each is held against the fp32 gradient (the port's fp32
  network, which other tests hold to the JAX one at 1e-4), its error at
  most twice the flax bf16 gradient's plus 1e-2 of its largest (measured:
  at most 1.65 times);
- three `SRModel` steps with `compute_dtype: bfloat16` (L1 + MS-SSIM,
  AdamW, EMA, a 4x SwinIR of one group of 2 blocks at 48x48 LR, where
  MS-SSIM's five scales fit) against the JAX `SRModel`: each step's logged
  losses within 5e-3 relative; the fp32 parameters and EMA parameters
  after three steps within 1e-4 (half of lr) wherever the fp32 step-1
  gradient is above 0.3 of its tensor's largest, and within 6 lr
  everywhere (bf16 rounding may flip the sign of a small gradient, and
  with it Adam's step of about lr);
- the fp32 twin: after bf16 steps, `test` (the EMA network) and
  validation's forward equal, bit for bit, an fp32 SwinIR holding the same
  parameters;
- the dtype policy: `compute_dtype: bfloat16`, no dtype at all (the JAX
  default) and `use_amp: true` train in bf16, `compute_dtype: float32` in
  fp32.
"""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _config, _opts, _to_port
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

SMALL = {"type": "swinir_m", "embed_dim": 32, "depths": [2, 2], "num_heads": [2, 2],
         "drop_path_rate": 0}
STEPS_NET = {"type": "swinir_m", "embed_dim": 32, "depths": [2], "num_heads": [2],
             "drop_path_rate": 0}
OUT_TOL = 2e-2  # of the largest |output|
GRAD_RATIO, GRAD_SLACK = 2.0, 1e-2  # port's bf16 error <= RATIO x flax's + SLACK x largest
LOSS_RTOL = 5e-3
LR = 2e-4  # the steps' AdamW learning rate (test_torch_train's config)
PARAM_TOL = LR / 2
LIVE = 0.3  # parameters whose fp32 step-1 gradient is at least this share of its tensor's largest


def _jax_flat(net_opt: dict, scale: int, lr_side: int) -> dict:
    """The flax network's flattened parameters, init plus noise."""
    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    net = build_network({**net_opt, "scale": scale})
    params = net.init(jax.random.key(0), jnp.zeros((1, lr_side, lr_side, 3)), train=False)
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(params["params"]).items()}
    return flat


def test_bf16_swinir_matches_flax(monkeypatch):
    from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
    from trainner_redux_tpu.models.base_model import BaseModel
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.ops import fused_block as tfb
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    flat = _jax_flat(SMALL, 2, 16)
    jnet = jax_build_cast({**SMALL, "scale": 2}, jnp.bfloat16)
    rng = np.random.default_rng(4)
    lr = rng.random((2, 16, 16, 3)).astype(np.float32)
    wout = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(lr), train=True)
        return jnp.sum(out * wout), out

    params = BaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    want_g = _to_port(BaseModel.flatten_params(jgrads))

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    nets = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = build_network_cast({**SMALL, "scale": 2}, dtype)
        assert net.compute_dtype == dtype
        net.load_state_dict(state_dict_from_jax(flat), strict=True)
        net.train()
        calls = tfb.fused_swin_block_train_bf16.launches  # CPU: the plain versions, uncounted
        out = net(torch.from_numpy(lr).permute(0, 3, 1, 2))
        assert out.dtype == torch.float32 and calls == tfb.fused_swin_block_train_bf16.launches
        (out * torch.from_numpy(wout).permute(0, 3, 1, 2)).sum().backward()
        nets[dtype] = (out.detach().permute(0, 2, 3, 1).numpy(),
                       {k: p.grad.numpy() for k, p in net.named_parameters()})
    got, got_g = nets[torch.bfloat16]
    want = np.asarray(want)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= OUT_TOL * top, f"output: max|diff| {err:.3g} vs max {top:.3g}"
    fp32_g = nets[torch.float32][1]
    for k, g in got_g.items():
        assert g.dtype == np.float32, k
        top = np.abs(fp32_g[k]).max()
        port, flax = np.abs(g - fp32_g[k]).max(), np.abs(want_g[k] - fp32_g[k]).max()
        assert port <= GRAD_RATIO * flax + GRAD_SLACK * top, (
            f"{k}: bf16 off fp32 by {port:.3g} (flax bf16 {flax:.3g}) of max|g| {top:.3g}")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 random 192x192 HR images and their 4x box-down 48x48 LR."""
    root = tmp_path_factory.mktemp("bf16_ds")
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        hr = (rng.random((192, 192, 3)) * 255).astype(np.uint8)
        lr = hr.reshape(48, 4, 48, 4, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(root / "hr" / f"img{i}.png"), hr)
        cv2.imwrite(str(root / "lr" / f"img{i}.png"), lr)
    return root


def _bf16_config(dataset: Path, weights: Path | None = None, **extra) -> dict:
    cfg = _config(dataset, weights, **extra)
    cfg["name"] = "torch_bf16_train_parity"
    cfg["scale"] = 4
    cfg["compute_dtype"] = "bfloat16"
    cfg["network_g"] = dict(STEPS_NET)
    cfg["datasets"]["train"]["lq_size"] = 48
    cfg["train"]["losses"] = [{"type": "l1loss", "loss_weight": 1.0},
                              {"type": "mssimloss", "loss_weight": 1.0}]
    cfg.update(extra)
    return cfg


def test_three_bf16_steps_match_jax(dataset, tmp_path, monkeypatch):
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JBase
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.archs.swinir_arch import SwinIR
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    flat = _jax_flat(STEPS_NET, 4, 48)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "swinir_m"})
    jopt, opt = _opts(tmp_path, _bf16_config(dataset, weights))
    jmodel = jbuild_model(jopt)
    assert jmodel.compute_dtype == jnp.bfloat16
    model = build_model(opt, device="cpu")
    assert model.compute_dtype == model.net_g.compute_dtype == torch.bfloat16
    for k, v in model.net_g.state_dict().items():  # the same fp32 start
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), _to_port(
            JBase.flatten_params(jmodel.state.params_g))[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)} for _ in range(3)]
    # the fp32 step-1 gradient: which parameters' signs bf16 leaves alone
    net32 = build_network({**STEPS_NET, "scale": 4})
    net32.load_state_dict(state_dict_from_jax(flat))
    lq, gt = (torch.from_numpy(batches[0][k]).float().permute(0, 3, 1, 2) / 255.0
              for k in ("lq", "gt"))
    model._generator_losses(net32.train()(lq), gt)[0].backward()
    fp32_g = {k: p.grad.numpy() for k, p in net32.named_parameters()}

    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        for key in ("l_g_l1", "l_g_mssim", "l_g_total"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")

    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(JBase.flatten_params(jparams))
        for k, v in net.state_dict().items():
            assert v.dtype == torch.float32, k
            err = np.abs(v.numpy() - want[k])
            assert err.max() <= 6 * LR, f"{name} {k}: {err.max():.3g}"
            live = err[np.abs(fp32_g[k]) >= LIVE * np.abs(fp32_g[k]).max()]
            assert live.max() <= PARAM_TOL, f"{name} {k}: {live.max():.3g}"

    # the fp32 twin: the EMA network serves in fp32 from the same parameters
    lq = batches[0]["lq"][:1].astype(np.float32) / 255.0
    got = model.test(lq)
    twin = SwinIR(upscale=4, embed_dim=32, depths=(2,), num_heads=(2,), drop_path_rate=0)
    twin.load_state_dict(model.net_g_ema.state_dict())
    with torch.no_grad():
        want = twin.eval()(torch.from_numpy(lq).permute(0, 3, 1, 2).contiguous())
    want = want.permute(0, 2, 3, 1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())
    assert model.net_g.training and model.net_g.compute_dtype == torch.bfloat16


@pytest.mark.parametrize(("extra", "dtype"), [
    ({"compute_dtype": "bfloat16"}, torch.bfloat16),
    ({"compute_dtype": None}, torch.bfloat16),  # unset: the JAX default
    ({"compute_dtype": "float32", "use_amp": True}, torch.bfloat16),
    ({"compute_dtype": "float32"}, torch.float32),
])
def test_dtype_policy(dataset, tmp_path, extra, dtype):
    from trainner_redux_tpu_torch.models import build_model

    cfg = _bf16_config(dataset)
    for k, v in extra.items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    jopt, opt = _opts(tmp_path, cfg)
    assert (jopt.compute_dtype == "bfloat16" or jopt.use_amp) == (dtype == torch.bfloat16)
    model = build_model(opt, device="cpu")
    assert model.compute_dtype == model.net_g.compute_dtype == dtype
    lq = torch.rand(1, 3, 16, 16)
    model.net_g.train()
    assert model.net_g(lq).dtype == torch.float32  # the output returns to fp32
