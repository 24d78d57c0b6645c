"""Training steps of the conv families against the JAX `SRModel`, on the CPU
(fp32; the loader's batches of tests/test_torch_train.py's config: scale 2,
16x16 LR crops, batch 2, AdamW, MultiStepLR, EMA 0.999):

- three L1 steps of a tiny SPAN (16 channels; Conv3XC's training form) and
  of a tiny Compact (8 features, 2 convolutions, PReLU) from equal weights
  (the port's seeded init through the JAX package's converter, saved as a
  JAX-framework file that both models load): step-1 gradients within 1e-4
  of each tensor's largest, the logged losses and gradient norm within
  1e-5 relative, parameters and EMA within 1e-5 after the three steps
  (entries with a live step-1 gradient, as tests/test_torch_hat.py).
The dict loss's logs through a step: tests/test_torch_conv_losses.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_span import shared_params
from tests.test_torch_train import _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.models.base_model import BaseModel as JaxBaseModel
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

NETS = {"SPAN": {"type": "span", "feature_channels": 16},
        "SRVGGNetCompact": {"type": "compact", "num_feat": 8, "num_conv": 2}}


def models(dataset_root: Path, tmp_path: Path, arch: str, losses=None):
    """(JAX SRModel, port SRModel) from one config and one weights file."""
    from safetensors.numpy import save_file

    from tests.test_torch_train import _config
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    flat, _ = shared_params(NETS[arch], 2, arch)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": arch})
    cfg = _config(dataset_root, weights)
    cfg["name"] = f"torch_{arch.lower()}_train_parity"
    cfg["network_g"] = dict(NETS[arch])
    if losses is not None:
        cfg["train"]["losses"] = losses
    jopt, opt = _opts(tmp_path, cfg)
    return jbuild_model(jopt), build_model(opt, device="cpu")


def batches(n: int, seed: int = 9):
    rng = np.random.default_rng(seed)
    return [{"lq": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)} for _ in range(n)]


@pytest.mark.parametrize("arch", list(NETS))
def test_three_steps_match_jax(arch, dataset, tmp_path):  # noqa: F811
    jmodel, model = models(dataset, tmp_path, arch)
    keys = model.net_g.state_dict().keys()

    def to_port(tree) -> dict[str, np.ndarray]:
        flat_tree = JaxBaseModel.flatten_params(tree)
        return {k: v.numpy() for k, v in state_dict_from_jax(flat_tree, arch, keys=keys).items()}

    start = to_port(jmodel.state.params_g)
    for k, v in model.net_g.named_parameters():  # the same start
        np.testing.assert_array_equal(v.detach().numpy(), start[k], err_msg=k)

    steps = batches(3)
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    want_g = to_port(grad_fn(jmodel.state.params_g,
                             jnp.asarray(steps[0]["lq"], jnp.float32) / 255.0,
                             jnp.asarray(steps[0]["gt"], jnp.float32) / 255.0))
    for i, batch in enumerate(steps, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
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
        want = to_port(jparams)
        for k, v in net.named_parameters():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            err = np.abs(v.detach().numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"
