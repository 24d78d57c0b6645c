"""The esrgan_gan workload's hsluv and cosim losses (bench.py) through one
training step of a tiny SPAN (L1 + hsluv charbonnier + cosim;
tests/test_torch_conv_train.py's models and batches) against the JAX
`SRModel`, on the CPU: the port logs hsluv's three terms apart
(`l_g_hsluv_hue`, `_saturation`, `_lightness`), as the JAX step does, every
loss log within 1e-5 relative, and its gradient norm is finite (JAX's is
NaN in this step: the random network's output has pixels clipped to black,
where the JAX hsluv gradient is NaN; tests/test_torch_conv_losses.py).
"""

import numpy as np

from tests.test_torch_train import dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

# the esrgan_gan workload's hsluv and cosim (bench.py), beside L1
GAN_PAIR_LOSSES = [{"type": "l1loss", "loss_weight": 1.0},
                   {"type": "hsluvloss", "criterion": "charbonnier", "loss_weight": 1.0},
                   {"type": "cosimloss", "loss_weight": 1.0}]


def test_dict_loss_logs_match_jax(dataset, tmp_path):  # noqa: F811
    from tests.test_torch_conv_train import batches, models

    jmodel, model = models(dataset, tmp_path, "SPAN", GAN_PAIR_LOSSES)
    batch = batches(1, seed=4)[0]
    jmodel.feed_data(batch)
    jmodel.optimize_parameters(1)
    jlog = jmodel.get_current_log()
    model.feed_data(batch)
    model.optimize_parameters(1)
    log = model.get_current_log()
    hsluv = {f"l_g_hsluv_{k}" for k in ("hue", "saturation", "lightness")}
    want = {"l_g_l1", "l_g_cosim", "l_g_total"} | hsluv
    assert want <= log.keys() and want <= jlog.keys()
    assert "l_g_hsluv" not in log
    for key in sorted(want):
        np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=key)
    assert np.isfinite(log["grad_norm_g"])
