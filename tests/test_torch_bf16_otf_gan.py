"""One bf16 OTF + GAN step on the port against the JAX `RealESRGANModel`,
on the CPU (the port's kernel wrappers run their bf16 plain versions; the
JAX package its Pallas kernels in interpret mode): tests/test_torch_
realesrgan.py's tiny 4x SwinIR and deterministic degradation with DUnet
(num_feat 16) and L1 + vanilla GAN 0.1, `compute_dtype: bfloat16`, from the
same G and D weights and (u, v), the crop offsets the JAX program draws
passed to the port (as the fp32 OTF tests do). The degradation runs in fp32
on both sides: the LQs within one 8-bit level. The networks run in bf16:
the port step's logged G and D losses within 5e-3 relative of the JAX
step's at its start (`jax_step_start`; the bf16 steps' limit, PERF.md
section 2; tests/test_torch_bf16_gan.py holds the GAN step's gradients).
"""

import numpy as np
import torch

from tests.test_torch_bf16_gan import GAN_STEP_LOSSES, LOSS_RTOL, jax_step_start
from tests.test_torch_gan_train import DUNET, _same_start
from tests.test_torch_realesrgan import (  # noqa: F401 (fixtures)
    DETERMINISTIC,
    _jax_offsets,
    gt_root,
    jax_weights4,
    otf_config,
)
from tests.test_torch_train import _opts
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


def test_one_bf16_otf_gan_step_matches_jax(gt_root, jax_weights4, tmp_path,  # noqa: F811
                                           monkeypatch):
    """Real-ESRGAN OTF with the GAN in bf16: the degradation in fp32 on both
    sides (the LQs within one 8-bit level), the networks in bf16."""
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    cfg = otf_config(gt_root, jax_weights4, **DETERMINISTIC)
    cfg["compute_dtype"] = "bfloat16"
    cfg["network_d"] = dict(DUNET)
    cfg["train"]["losses"] = [dict(lo) for lo in GAN_STEP_LOSSES]
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    assert model.net_g.compute_dtype == model.net_d.compute_dtype == torch.bfloat16
    _same_start(jmodel, model)
    ds = build_dataset(opt.datasets["train"], seed=3)
    batch = {k: np.stack([ds[i][k] for i in (0, 1)])
             for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
    offsets = _jax_offsets(1)
    model._crop_offsets = lambda *_: offsets
    jmodel.feed_data(batch)
    model.feed_data(batch)
    assert model.lq.dtype == torch.float32
    assert np.abs(model.lq.numpy() - np.asarray(jmodel.lq)).max() <= 1 / 255
    jlog = jax_step_start(jmodel, jmodel.lq, jmodel.gt, grads=False)
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK")
    model.optimize_parameters(1)
    log = model.get_current_log()
    for key in ("l_g_l1", "l_g_gan", "l_g_total", "l_d_real", "l_d_fake"):
        np.testing.assert_allclose(log[key], jlog[key], rtol=LOSS_RTOL, err_msg=key)
