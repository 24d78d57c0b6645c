"""Three bf16 `SRModel` steps of a tiny Swin2SR (tests/test_torch_swin2sr.py's:
embed 24, one group of two blocks, 3 heads of 8, window 8; 2x, batch 2 of
16x16 LR crops, the second block shifted; L1, AdamW, EMA) against the JAX
`SRModel` with `compute_dtype: bfloat16` from equal weights and batches, on
the CPU (the port's kernel wrappers run the bf16 plain versions of
#11-#14; the JAX Swin2Blocks run their Pallas kernels in interpret mode):
the logged losses within 5e-3 relative, the fp32 parameters and EMA
parameters within lr / 2 wherever the fp32 step-1 gradient is above 0.3 of
its tensor's largest and within 6 lr everywhere (bf16 may flip the sign of
a small gradient, and with it Adam's step of about lr; the bf16 training
tests' limits, tests/test_torch_bf16_srformerv2_steps.py); the EMA network
then serves in fp32 (the twin), bit for bit an fp32 Swin2SR of the same
parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train import dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

LOSS_RTOL = 5e-3
LR = 2e-4  # the steps' AdamW learning rate (tests/test_torch_train.py's config)
LIVE = 0.3  # parameters whose fp32 step-1 gradient is at least this share of its tensor's largest


def test_three_bf16_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    from safetensors.numpy import save_file

    from tests.test_torch_swin2sr import TINY, _to_port
    from tests.test_torch_train import _config, _opts
    from trainner_redux_tpu.archs import build_network as jax_build_network
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    rng = np.random.default_rng(8)
    params = jax_build_network({**TINY, "scale": 2}).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)["params"]
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in JaxBaseModel.flatten_params(params).items()}
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu",
                                            "arch": "swin2sr_m"})
    cfg = _config(dataset, weights, compute_dtype="bfloat16")
    cfg["name"] = "torch_bf16_swin2sr_parity"
    cfg["network_g"] = dict(TINY)
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    assert jmodel.compute_dtype == jnp.bfloat16
    model = build_model(opt, device="cpu")
    assert model.net_g.compute_dtype == torch.bfloat16
    start = _to_port(jmodel.state.params_g)
    for k, v in model.net_g.state_dict().items():  # the same fp32 start
        np.testing.assert_array_equal(v.numpy(), start[k], err_msg=k)

    batches = [{"lq": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)} for _ in range(3)]
    net32 = build_network({**TINY, "scale": 2})
    net32.load_state_dict(state_dict_from_jax(flat, "Swin2SR"))
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
    lq = rng.random((1, 32, 32, 3)).astype(np.float32)
    got = model.test(lq)
    twin = build_network({**TINY, "scale": 2})
    twin.load_state_dict(model.net_g_ema.state_dict())
    with torch.no_grad():
        want = twin.eval()(torch.from_numpy(lq).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy())
    assert model.net_g.training and model.net_g.compute_dtype == torch.bfloat16
