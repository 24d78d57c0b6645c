"""Three training steps of a tiny SRFormerV2 in the port against the JAX
package's `SRModel`, on the CPU (the port's kernel wrappers run their plain
versions, the JAX side its Pallas kernels in interpret mode).

The tiny SRFormerV2 of tests/test_torch_srformerv2.py (embed 32, one layer
of 2 PSA and 3 Swin blocks, 2 heads, window 12, squeeze 8, 2x), batch 2 of
24x24 LR (2x2 windows, the second PSA block shifted by 6), L1, AdamW, EMA
0.999, fp32, under TRAINNER_FUSED_BLOCK=interpret: each Swin block through
`fused_attn_block` (#1, backward #6) and `fused_ln_mlp` (#2, backward #7)
on both sides, the backwards counted through the port's wrappers. Step-1
gradients within 1e-4 of each tensor's largest; the logged loss and
gradient norm within 1e-5 relative; params and EMA within 1e-5 (entries
with a live step-1 gradient, as in tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_srformerv2 import TINY, _jax_flat
from tests.test_torch_train import _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax


def _to_port(tree) -> dict[str, np.ndarray]:
    flat = JaxBaseModel.flatten_params(tree)
    return {k: np.asarray(v) for k, v in state_dict_from_jax(flat, "SRFormerV2").items()}


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    from safetensors.numpy import save_file

    from tests.test_torch_train import _config
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.ops import fused_block as fb

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    _, flat = _jax_flat(noise=0.02)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu",
                                            "arch": "srformerv2"})
    cfg = _config(dataset, weights)
    cfg["name"] = "torch_srformerv2_train_parity"
    cfg["network_g"] = dict(TINY)
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), _to_port(jmodel.state.params_g)[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)} for _ in range(3)]
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    want_g = _to_port(grad_fn(jmodel.state.params_g,
                              jnp.asarray(batches[0]["lq"], jnp.float32) / 255.0,
                              jnp.asarray(batches[0]["gt"], jnp.float32) / 255.0))

    backwards = {"attn": 0, "mlp": 0}
    for key, name in (("attn", "fused_attn_block_backward"), ("mlp", "fused_ln_mlp_backward")):
        real = getattr(fb, name)

        def counted(*a, _real=real, _key=key):
            backwards[_key] += 1
            return _real(*a)

        monkeypatch.setattr(fb, name, counted)
    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            assert backwards == {"attn": 3, "mlp": 3}  # three Swin blocks, through the wrappers
            got_g = {k: p.grad.numpy() for k, p in model.net_g.named_parameters()}
            assert set(got_g) == set(want_g)
            for k, w in want_g.items():
                err = np.abs(got_g[k] - w).max()
                assert err <= 1e-4 * np.abs(w).max(), f"{k}: {err:.3g} vs {np.abs(w).max():.3g}"
        for key in ("l_g_l1", "l_g_total", "grad_norm_g"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {i}")

    gmax = max(np.abs(w).max() for w in want_g.values())
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        for k, v in net.state_dict().items():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            err = np.abs(v.numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"
