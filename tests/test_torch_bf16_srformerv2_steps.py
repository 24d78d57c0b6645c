"""Two bf16 `SRModel` steps of tests/test_torch_srformerv2.py's tiny
SRFormerV2 (embed 32, one layer of 2 PSA and 3 Swin blocks, 2 heads,
window 12, squeeze 8, 2x, batch 2 of 24x24 LR; L1, AdamW, EMA) against the
JAX `SRModel` with `compute_dtype: bfloat16` from equal weights and
batches, on the CPU (the port's kernel wrappers run their bf16 plain
versions; the JAX Swin blocks run their Pallas kernels in interpret mode):
the logged losses within 5e-3 relative, the fp32 parameters and EMA
parameters within lr / 2 wherever the fp32 step-1 gradient is above 0.3 of
its tensor's largest and within 6 lr everywhere (bf16 may flip the sign of
a small gradient, and with it Adam's step of about lr; the bf16 training
tests' limits, tests/test_torch_bf16_train.py); the EMA network then
serves in fp32 (the twin), bit for bit an fp32 SRFormerV2 of the same
parameters.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train import dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

LOSS_RTOL = 5e-3
LR = 2e-4  # the steps' AdamW learning rate (tests/test_torch_train.py's config)
LIVE = 0.3  # parameters whose fp32 step-1 gradient is at least this share of its tensor's largest


def test_two_bf16_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    from safetensors.numpy import save_file

    from tests.test_torch_srformerv2 import TINY, _jax_flat
    from tests.test_torch_srformerv2_train import _to_port
    from tests.test_torch_train import _config, _opts
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(noise=0.02)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu",
                                            "arch": "srformerv2"})
    cfg = _config(dataset, weights, compute_dtype="bfloat16")
    cfg["name"] = "torch_bf16_srformerv2_parity"
    cfg["network_g"] = dict(TINY)
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    assert jmodel.compute_dtype == jnp.bfloat16
    model = build_model(opt, device="cpu")
    assert model.net_g.compute_dtype == torch.bfloat16
    start = _to_port(jmodel.state.params_g)
    for k, v in model.net_g.state_dict().items():  # the same fp32 start
        np.testing.assert_array_equal(v.numpy(), start[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)} for _ in range(2)]
    net32 = build_network({**TINY, "scale": 2})
    net32.load_state_dict(state_dict_from_jax(flat, "SRFormerV2"))
    lq, gt = (torch.from_numpy(batches[0][k]).float().permute(0, 3, 1, 2) / 255.0
              for k in ("lq", "gt"))
    model._generator_losses(net32.train()(lq), gt)[0].backward()
    fp32_g = {k: p.grad.numpy() for k, p in net32.named_parameters()}

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    for i, batch in enumerate(batches, start=1):
        monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        monkeypatch.delenv("TRAINNER_FUSED_BLOCK")
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        for key in ("l_g_l1", "l_g_total"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")

    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        for k, v in net.state_dict().items():
            assert v.dtype == torch.float32, k
            err = np.abs(v.numpy() - want[k])
            assert err.max() <= 6 * LR, f"{name} {k}: {err.max():.3g}"
            live = err[np.abs(fp32_g[k]) >= LIVE * np.abs(fp32_g[k]).max()]
            assert live.size == 0 or live.max() <= LR / 2, f"{name} {k}: {live.max():.3g}"

    # the fp32 twin: the EMA network serves in fp32 from the same parameters
    # (48x48: `test` pads to a multiple of 16, the network to one of 12)
    lq = rng.random((1, 48, 48, 3)).astype(np.float32)
    got = model.test(lq)
    twin = build_network({**TINY, "scale": 2})
    twin.load_state_dict(model.net_g_ema.state_dict())
    with torch.no_grad():
        want = twin.eval()(torch.from_numpy(lq).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy())
    assert model.net_g.training and model.net_g.compute_dtype == torch.bfloat16
