"""Three bf16 `SRModel` steps of HAT and DAT (SwinIR-L's in
tests/test_torch_bf16_swinir_l_steps.py, which `three_bf16_steps` serves
too) on the port against the JAX `SRModel`, on the CPU (the port's kernel wrappers run their bf16
plain versions; the JAX package runs its Pallas kernels in interpret mode,
TRAINNER_FUSED_BLOCK=interpret), as their fidelity templates train:
`compute_dtype: bfloat16`, L1 + MS-SSIM, AdamW, EMA, 4x at 48x48 LR, where
MS-SSIM's five scales fit; batch 2 and tiny widths (the networks of
tests/test_torch_bf16_families.py). Each step's logged losses within 5e-3
relative, as the bf16 SwinIR's (tests/test_torch_bf16_train.py); after three
steps the fp32 parameters within 6 lr everywhere (bf16 rounding may flip the
sign of a small gradient, and with it Adam's step of about lr); and the
EMA network serves in fp32 (the fp32 twin) with a finite output.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_families import NETS, _jax_flat
from tests.test_torch_train import _config, _opts
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

LOSS_RTOL = 5e-3
LR = 2e-4  # the steps' AdamW learning rate (test_torch_train's config)
LQ = 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 random 192x192 HR images and their 4x box-down 48x48 LR."""
    root = tmp_path_factory.mktemp("bf16_family_ds")
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        hr = (rng.random((4 * LQ, 4 * LQ, 3)) * 255).astype(np.uint8)
        lr = hr.reshape(LQ, 4, LQ, 4, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(root / "hr" / f"img{i}.png"), hr)
        cv2.imwrite(str(root / "lr" / f"img{i}.png"), lr)
    return root


@pytest.mark.parametrize("arch", ["HAT", "DAT"])
def test_three_bf16_steps_match_jax(arch, dataset, tmp_path, monkeypatch):
    three_bf16_steps(arch, dataset, tmp_path, monkeypatch)


def three_bf16_steps(arch, dataset, tmp_path, monkeypatch):
    """The three steps of `arch` (a key of NETS) against the JAX SRModel."""
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JBase
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    net_opt = NETS[arch]
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    flat = _jax_flat(net_opt, scale=4)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights),
              metadata={"framework": "trainner_redux_tpu", "arch": net_opt["type"]})
    cfg = _config(dataset, weights, compute_dtype="bfloat16", scale=4,
                  network_g=dict(net_opt), name=f"torch_bf16_{arch.lower()}_steps")
    cfg["datasets"]["train"]["lq_size"] = LQ
    cfg["train"]["losses"] = [{"type": "l1loss", "loss_weight": 1.0},
                              {"type": "mssimloss", "loss_weight": 1.0}]
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    assert jmodel.compute_dtype == jnp.bfloat16
    model = build_model(opt, device="cpu")
    assert model.compute_dtype == model.net_g.compute_dtype == torch.bfloat16

    def to_port(tree):
        return {k: np.asarray(v)
                for k, v in state_dict_from_jax(JBase.flatten_params(tree), arch).items()}

    start = to_port(jmodel.state.params_g)
    for k, v in model.net_g.state_dict().items():  # the same fp32 start
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), start[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, LQ, LQ, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 4 * LQ, 4 * LQ, 3), dtype=np.uint8)}
               for _ in range(3)]
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

    want = to_port(jmodel.state.params_g)
    for k, v in model.net_g.state_dict().items():
        assert v.dtype == torch.float32, k
        err = np.abs(v.numpy() - want[k]).max()
        assert err <= 6 * LR, f"params {k}: {err:.3g}"
    out = model.test(batches[0]["lq"][:1].astype(np.float32) / 255.0)
    assert out.dtype == np.float32 and out.shape == (1, 4 * LQ, 4 * LQ, 3)
    assert np.isfinite(out).all()
    assert model.net_g.training and model.net_g.compute_dtype == torch.bfloat16
