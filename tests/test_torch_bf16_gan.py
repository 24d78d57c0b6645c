"""bf16 GAN training on the port against the JAX package, on the CPU (the
port's kernel wrappers run their bf16 plain versions; the JAX package runs
its Pallas kernels in interpret mode, TRAINNER_FUSED_BLOCK=interpret).

- One bf16 GAN step of tests/test_torch_gan_train.py's tiny SwinIR (2x, LR
  16x16, batch 2) with DUnet (num_feat 8) and L1 + vanilla GAN 0.1 against
  the JAX `SRModel` with `compute_dtype: bfloat16`, from the same G and D
  weights and (u, v): the JAX step's losses at its start, as its train
  step computes them (the generator's `_generator_losses`, the D loss on
  the JAX generator's output, jitted without the update: one XLA compile
  fewer than a whole step); the port step's logged G and D losses within
  5e-3 relative and D's mean outputs within 5e-3 of 1 (the bf16 steps'
  limit, PERF.md section 2); G's and D's gradients (jax.grad of those
  losses) held against an fp32 port step's as tests/test_torch_bf16_
  dunet.py holds DUnet's (`hold_to_fp32`).
The bf16 DUnet against flax and one bf16 OTF + GAN step are in
tests/test_torch_bf16_dunet.py and tests/test_torch_bf16_otf_gan.py (each
file under a minute on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_gan_train import (  # noqa: F401 (fixtures)
    DUNET,
    GAN_LOSSES,
    _batches,
    _same_start,
    gan_config,
    jax_weights,
)
from tests.test_torch_train import _opts, _to_port, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.models.base_model import BaseModel as JBase
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

GRAD_RATIO, GRAD_SLACK = 2.0, 1e-2  # port's bf16 L2 error <= RATIO x flax's + SLACK x |fp32 g|
LOSS_RTOL = 5e-3
GAN_STEP_LOSSES = [GAN_LOSSES[0], GAN_LOSSES[2]]  # L1 + vanilla GAN 0.1


def hold_to_fp32(what: str, got: dict, flax: dict, fp32: dict) -> None:
    """Each bf16 gradient's L2 distance from the fp32 one at most GRAD_RATIO
    times flax's plus GRAD_SLACK of the fp32 gradient's norm: the port
    rounds after every operation, as flax does on the chip, where XLA's CPU
    lowering keeps fp32 between fused ones (tests/test_torch_bf16_
    srformerv2.py)."""
    assert got.keys() == fp32.keys() <= flax.keys(), what
    for k, g in got.items():
        port, ref = (np.linalg.norm(np.asarray(a, np.float32) - fp32[k]) for a in (g, flax[k]))
        top = np.linalg.norm(fp32[k])
        assert port <= GRAD_RATIO * ref + GRAD_SLACK * top, (
            f"{what} {k}: bf16 off fp32 by {port:.3g} in L2 (flax bf16 {ref:.3g}) of |g| "
            f"{top:.3g}")


def jax_step_start(jmodel, lq, gt, grads: bool = True):
    """The JAX model's step at its start, as its train step computes it
    (jitted here, without the optimizer update): the generator's logged
    losses and the discriminator's (l_d_real, l_d_fake and D's mean outputs,
    on the JAX generator's own output), and with `grads` jax.grad of each
    loss in the port's names. lq and gt NHWC float in [0, 1]."""
    from trainner_redux_tpu.losses.gan_loss import GANLoss

    st = jmodel.state
    key = jax.random.key(0)
    gan = GANLoss(gan_type="vanilla")

    def g_loss(p):
        total, (logs, out, _) = jmodel._generator_losses(p, st.params_d, st.extra_d, None, lq,
                                                         gt, 0, key)
        return total, (logs, out)

    def d_loss(pd, fake):
        d_apply = jmodel._d_apply_fn(pd, st.extra_d)
        real, fake = d_apply(gt), d_apply(jax.lax.stop_gradient(fake))
        l_real, l_fake = gan(real, True, is_disc=True), gan(fake, False, is_disc=True)
        return l_real + l_fake, {"l_d_real": l_real, "l_d_fake": l_fake,
                                 "out_d_real": real.mean(), "out_d_fake": fake.mean()}

    if grads:
        (_, (logs, fake)), g_grads = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(
            st.params_g)
        (_, d_logs), d_grads = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(st.params_d,
                                                                                 fake)
    else:
        _, (logs, fake) = jax.jit(g_loss)(st.params_g)
        _, d_logs = jax.jit(d_loss)(st.params_d, fake)
    logs = {k: float(v) for k, v in {**logs, **d_logs}.items()}
    if not grads:
        return logs
    return (logs, _to_port(JBase.flatten_params(g_grads)),
            {k: np.asarray(v) for k, v in
             state_dict_from_jax(JBase.flatten_params(d_grads), "DUnet").items()})


def test_one_bf16_gan_step_matches_jax(dataset, jax_weights, tmp_path, monkeypatch):  # noqa: F811
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    cfg = gan_config(dataset, jax_weights)
    cfg["compute_dtype"] = "bfloat16"
    cfg["network_d"] = {**DUNET, "num_feat": 8}
    cfg["train"]["losses"] = [dict(lo) for lo in GAN_STEP_LOSSES]
    for sub in ("bf16", "fp32"):
        (tmp_path / sub).mkdir()
    jopt, opt = _opts(tmp_path / "bf16", cfg)
    jmodel = jbuild_model(jopt)
    assert jmodel.compute_dtype == jnp.bfloat16
    model = build_model(opt, device="cpu")
    assert model.net_g.compute_dtype == model.net_d.compute_dtype == torch.bfloat16
    _same_start(jmodel, model)
    cfg["compute_dtype"] = "float32"
    _, opt32 = _opts(tmp_path / "fp32", cfg)
    model32 = build_model(opt32, device="cpu")
    _same_start(jmodel, model32)
    batch = _batches(1)[0]
    jlog, flax_g, flax_d = jax_step_start(
        jmodel, *(jnp.asarray(batch[k], jnp.float32) / 255.0 for k in ("lq", "gt")))
    monkeypatch.delenv("TRAINNER_FUSED_BLOCK")
    grads = {}
    for m in (model, model32):
        m.feed_data(batch)
        m.optimize_parameters(1)
        grads[m] = ({k: p.grad.numpy() for k, p in m.net_g.named_parameters()},
                    {k: p.grad.numpy() for k, p in m.net_d.named_parameters()})
    log = model.get_current_log()
    for key in ("l_g_l1", "l_g_gan", "l_g_total", "l_d_real", "l_d_fake"):
        np.testing.assert_allclose(log[key], jlog[key], rtol=LOSS_RTOL, err_msg=key)
    for key in ("out_d_real", "out_d_fake"):
        np.testing.assert_allclose(log[key], jlog[key], atol=LOSS_RTOL, err_msg=key)
    hold_to_fp32("G", grads[model][0], flax_g, grads[model32][0])
    hold_to_fp32("D", grads[model][1], flax_d, grads[model32][1])
