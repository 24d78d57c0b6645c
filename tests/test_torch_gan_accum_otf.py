"""GAN training, torch port vs JAX package, on the CPU: the forms of the
step that tests/test_torch_gan_train.py leaves to this file, so that each
file runs in about two minutes.

- three GAN steps as there, with `accum_iter: 2`: the GAN term and its
  gradient averaged over the micro-batches, D fed micro-batch 0's output
  and GT, as the JAX step feeds it;
- two OTF + GAN steps (Real-ESRGAN on-the-fly degradation, whose
  RealESRGANModel inherits the D path) against the JAX `RealESRGANModel`
  on tests/test_torch_realesrgan.py's deterministic degradation: the G and
  D losses and the gradient norm within 1e-5 relative where the LQs are
  equal, 1e-3 where an 8-bit level apart.
"""

import numpy as np

from tests.test_torch_gan_train import (  # noqa: F401 (fixtures)
    DUNET,
    GAN_LOSSES,
    _same_start,
    jax_weights,
    three_gan_steps,
)
from tests.test_torch_realesrgan import (  # noqa: F401 (fixtures)
    DETERMINISTIC,
    _jax_offsets,
    gt_root,
    jax_weights4,
    otf_config,
)
from tests.test_torch_train import _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


def test_three_gan_steps_with_accum_match_jax(dataset, jax_weights, tmp_path,  # noqa: F811
                                              monkeypatch):
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    three_gan_steps(dataset, jax_weights, tmp_path, accum=2)


def test_two_otf_gan_steps_match_jax(gt_root, jax_weights4, tmp_path, monkeypatch):  # noqa: F811
    """Real-ESRGAN OTF with the GAN: RealESRGANModel inherits the D path."""
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    cfg = otf_config(gt_root, jax_weights4, **DETERMINISTIC)
    cfg["network_d"] = dict(DUNET)
    cfg["train"]["losses"] = [GAN_LOSSES[0], GAN_LOSSES[2]]
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    _same_start(jmodel, model)
    ds = build_dataset(opt.datasets["train"], seed=3)
    for step in (1, 2):
        batch = {k: np.stack([ds[i][k] for i in (2 * step - 2, 2 * step - 1)])
                 for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
        offsets = _jax_offsets(step)
        model._crop_offsets = lambda *_, o=offsets: o
        jmodel.feed_data(batch)
        model.feed_data(batch)
        diff = np.abs(model.lq.numpy() - np.asarray(jmodel.lq))
        assert diff.max() <= 1 / 255
        jmodel.optimize_parameters(step)
        model.optimize_parameters(step)
        log, jlog = model.get_current_log(), jmodel.get_current_log()
        # an LQ pixel one 8-bit level apart moves what follows it by about
        # 4e-4 (tests/test_torch_realesrgan.py); equal inputs hold 1e-5
        tol = 1e-5 if not (diff > 1e-6).any() else 1e-3
        for key in ("l_g_l1", "l_g_gan", "l_g_total", "grad_norm_g", "l_d_real", "l_d_fake"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=tol, err_msg=f"{key} {step}")
