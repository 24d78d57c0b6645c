"""GAN training, torch port vs JAX package, on the CPU (the port's kernel
wrappers run their plain versions; the JAX package runs its Pallas kernels
in interpret mode, TRAINNER_FUSED_BLOCK=interpret).

- three steps of a tiny SwinIR (as tests/test_torch_train.py: embed 24,
  depths [2, 2], scale 2, LR 16x16, batch 2, AdamW, MultiStepLR with a
  milestone inside the run, EMA 0.999) with DUnet (num_feat 16) and L1 +
  perceptual (VGG19, the seeded random init) + vanilla GAN 0.1, from the
  same G and D weights and (u, v): each step's logged G and D losses,
  gradient norm and both learning rates within 1e-5 relative, D's mean
  outputs within 1e-5; after 3 steps G, EMA and D params within 1e-5 (entries whose
  step-1 gradient is below 1e-6 of the network's largest left out, as in
  tests/test_torch_train.py) and every (u, v) within 1e-5 (with
  `accum_iter: 2` in tests/test_torch_gan_accum_otf.py);
- the same with `adaptive_d: true` (a fast EMA, a threshold below 1),
  whose skip pattern over four steps must match and must skip at least
  once and step at least once; a skip leaves D, its (u, v) and its
  optimizer state as they were, and D's learning rate follows its own
  count of updates past the milestone, as optax's does;
- `train.run` with a checkpoint: net_d_<iter> under resume_models loads
  back strictly into DUnet, and a resume restores G, D with its (u, v),
  both optimizers and the adaptive-D state bit for bit, so that the next
  step of the resumed model and of the saving one agree bit for bit;
- the template `swinir_m_gan.yml` with `compute_dtype: float32` (and a
  tiny network and dataset) trains;
- the refusals that remain: other discriminators, GAN losses without
  network_d, R3GAN and feature matching.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_train import _config, _opts, _to_port, _yaml, dataset  # noqa: F401
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

# its limits were set at torch's default thread count (tests/torch_threads.py)
TORCH_DEFAULT_THREADS = ("test_three_gan_steps_match_jax",)
REPO = Path(__file__).resolve().parent.parent
DUNET = {"type": "dunet", "num_feat": 16}
# the perceptual loss at its two shallow default taps: the deeper ones, at a
# 32x32 crop, reach 4x4 and 2x2 maps through max pools and ReLUs whose
# choices flip under the two packages' rounding-level different G outputs,
# moving the loss's gradient far beyond the steps' 1e-5;
# tests/test_torch_gan_losses.py holds every default tap against JAX on
# one input
GAN_LOSSES = [{"type": "l1loss", "loss_weight": 1.0},
              {"type": "perceptualloss", "loss_weight": 1.0,
               "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1}},
              {"type": "ganloss", "gan_type": "vanilla", "loss_weight": 0.1}]
LOG_KEYS = ("l_g_l1", "l_g_perceptual", "l_g_gan", "l_g_total", "grad_norm_g", "l_d_real",
            "l_d_fake", "out_d_real", "out_d_fake")


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A JAX-framework safetensors of the tiny SwinIR at 2x, init plus
    noise."""
    from safetensors.numpy import save_file

    from tests.test_torch_train import NET
    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    net = build_network({**NET, "scale": 2})
    params = net.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(params).items()}
    path = tmp_path_factory.mktemp("gan_weights") / "net_g.safetensors"
    save_file(flat, str(path), metadata={"framework": "trainner_redux_tpu", "arch": "swinir_m"})
    return path


def gan_config(dataset_root: Path, weights: Path | None = None, accum: int = 1,
               **train_extra) -> dict:
    cfg = _config(dataset_root, weights, accum)
    cfg["name"] = "torch_gan_parity"
    cfg["network_d"] = dict(DUNET)
    cfg["train"].update(losses=[dict(lo) for lo in GAN_LOSSES],
                        optim_d={"type": "AdamW", "lr": 2e-4}, **train_extra)
    return cfg


def _jax_d_state(jmodel) -> dict:
    """The JAX model's D params and spectral collection as one flat dict
    in `state_dict_from_jax`'s form."""
    from trainner_redux_tpu.models.base_model import BaseModel as JBase

    return {**JBase.flatten_params(jmodel.state.params_d),
            **{f"__spectral__.{k}": v for k, v in
               JBase.flatten_params(jmodel.state.extra_d["spectral"]).items()}}


def _same_start(jmodel, model) -> None:
    """The port's D takes the JAX D's weights and (u, v); G must already
    be equal."""
    from trainner_redux_tpu.models.base_model import BaseModel as JBase

    model.net_d.load_state_dict(state_dict_from_jax(_jax_d_state(jmodel), "DUnet"))
    for k, v in model.net_g.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _to_port(
            JBase.flatten_params(jmodel.state.params_g))[k], err_msg=k)


def _batches(n: int, accum: int = 1, seed: int = 9) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"lq": rng.integers(0, 256, (2 * accum, 16, 16, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (2 * accum, 32, 32, 3), dtype=np.uint8)}
            for _ in range(n)]


def _live(grads: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Entries whose gradient is at least 1e-6 of the largest (Adam turns
    rounding noise below that into steps of +-lr)."""
    gmax = max(np.abs(g).max() for g in grads.values())
    return {k: np.abs(g) >= 1e-6 * gmax for k, g in grads.items()}


def _check_params(what: str, got: dict, want: dict, live: dict, tol: float = 1e-5) -> None:
    for k, v in got.items():
        err = np.abs(v.numpy() - want[k].numpy() if hasattr(want[k], "numpy")
                     else v.numpy() - want[k])
        err = err[live[k]] if k in live else err
        assert err.size == 0 or err.max() <= tol, f"{what} {k}: {err.max():.3g}"


def _run_gan_steps(jmodel, model, batches, check_logs=LOG_KEYS):
    """Step both models through `batches`; returns the port's step-1 G and
    D gradients and the adaptive-D skips of each (JAX, port)."""
    skips = ([], [])
    g_grads = d_grads = None
    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            g_grads = {k: p.grad.numpy().copy() for k, p in model.net_g.named_parameters()}
            d_grads = {k: p.grad.numpy().copy() for k, p in model.net_d.named_parameters()}
        for key in check_logs:
            # D's mean outputs average logits of order 0.1 that can cancel
            # to near 0: they are held to 1e-5 absolute
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5,
                                       atol=1e-5 if key.startswith("out_d") else 0,
                                       err_msg=f"{key} step {i}")
        np.testing.assert_allclose(model.get_current_learning_rate(),
                                   jmodel.get_current_learning_rate(), rtol=1e-6)
        if "adaptive_d_skip" in jlog:
            skips[0].append(jlog["adaptive_d_skip"])
            skips[1].append(log["adaptive_d_skip"])
    return g_grads, d_grads, skips


def _check_state(jmodel, model, g_grads, d_grads) -> None:
    from trainner_redux_tpu.models.base_model import BaseModel as JBase

    g_live = _live(g_grads)
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        _check_params(name, net.state_dict(), _to_port(JBase.flatten_params(jparams)), g_live)
    want_d = state_dict_from_jax(_jax_d_state(jmodel), "DUnet")
    got_d = model.net_d.state_dict()
    assert set(got_d) == set(want_d)
    _check_params("net_d", got_d, want_d, _live(d_grads))


def three_gan_steps(dataset_root, weights, tmp_path, accum: int) -> None:
    """Three GAN steps of both packages from the same start, checked."""
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    jopt, opt = _opts(tmp_path, gan_config(dataset_root, weights, accum))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    _same_start(jmodel, model)
    g_grads, d_grads, _ = _run_gan_steps(jmodel, model, _batches(3, accum))
    assert model.get_current_learning_rate() == pytest.approx([1e-4, 1e-4])  # the milestone
    _check_state(jmodel, model, g_grads, d_grads)


def test_three_gan_steps_match_jax(dataset, jax_weights, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    three_gan_steps(dataset, jax_weights, tmp_path, accum=1)


def test_adaptive_d_skips_as_jax_does(dataset, jax_weights, tmp_path, monkeypatch):  # noqa: F811
    """A fast EMA and a threshold below 1 make the skip depend on each
    step's generator GAN loss; a skipped step leaves D, its (u, v) and
    its optimizer state (Adam's count) as they were."""
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    cfg = gan_config(dataset, jax_weights, adaptive_d=True, adaptive_d_ema_decay=0.5,
                     adaptive_d_threshold=0.97)
    cfg["train"]["total_iter"] = 4
    jopt, opt = _opts(tmp_path, cfg)
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    _same_start(jmodel, model)

    before = {}
    original = model._discriminator_step

    def watched(*args):
        before["d"] = {k: v.clone() for k, v in model.net_d.state_dict().items()}
        before["steps"] = [s["step"].clone() for s in model.optimizer_d.state.values()]
        original(*args)

    model._discriminator_step = watched
    steps = []
    for i, batch in enumerate(_batches(4, seed=11), start=1):
        g_grads, d_grads, skips = _run_gan_steps(jmodel, model, [batch])
        steps.append(skips)
        if skips[1][0]:
            for k, v in model.net_d.state_dict().items():
                assert torch.equal(v, before["d"][k]), f"step {i}: {k} moved on a skip"
            assert [s["step"] for s in model.optimizer_d.state.values()] == before["steps"]
        if i == 1:
            grads = (g_grads, d_grads)
    jskips = [s[0][0] for s in steps]
    assert [s[1][0] for s in steps] == jskips
    assert 0 < sum(jskips) < 4, f"the skip pattern {jskips} does not exercise both sides"
    _check_state(jmodel, model, *grads)


# ---------------------------------------------------------------------------
# the entry point, the template, the refusals
# ---------------------------------------------------------------------------


def test_train_run_saves_net_d_and_resumes_bit_for_bit(dataset, tmp_path, monkeypatch):  # noqa: F811
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import parse_options

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    cfg = gan_config(dataset, adaptive_d=True)
    cfg["train"]["total_iter"] = 2
    cfg["logger"]["save_checkpoint_freq"] = 2
    yml = _yaml(tmp_path, cfg)
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", yml])
    model = port_train.run(opt, device="cpu", opt_file=yml)
    exp = tmp_path / "experiments" / cfg["name"]
    net_d = exp / "models" / "resume_models" / "net_d_2.safetensors"
    assert net_d.exists() and model.step == 2

    # net_d_<iter> loads back strictly into DUnet
    fresh = build_network(dict(DUNET))
    model.load_network(fresh, str(net_d), strict=True)
    for k, v in model.net_d.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    # the resumed model holds the saved one's state bit for bit
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", yml])
    resumed = build_model(opt, device="cpu")
    resumed.resume_training(str(exp / "training_states" / "2.state"))
    for name in ("net_g", "net_g_ema", "net_d"):
        a, b = getattr(model, name).state_dict(), getattr(resumed, name).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{name} {k}"
    for name in ("optimizer_g", "optimizer_d"):
        a, b = getattr(model, name).state_dict()["state"], \
            getattr(resumed, name).state_dict()["state"]
        for i in a:
            for k in a[i]:
                assert torch.equal(a[i][k], b[i][k]), f"{name} {i} {k}"
    assert torch.equal(model.gan_ema, resumed.gan_ema) and resumed.step == 2

    # and the next step agrees bit for bit
    batch = _batches(1, seed=12)[0]
    for m in (model, resumed):
        m.feed_data(batch)
        m.optimize_parameters(3)
    assert model.log_dict.keys() == resumed.log_dict.keys()
    for k in model.log_dict:
        assert torch.equal(model.log_dict[k], resumed.log_dict[k]), k
    for name in ("net_g", "net_d"):
        a, b = getattr(model, name).state_dict(), getattr(resumed, name).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{name} {k} after a step"


def test_template_swinir_m_gan_trains_in_fp32(tmp_path, monkeypatch):
    """configs/_templates/train/SwinIR/swinir_m_gan.yml with compute_dtype
    float32 (its 4x, 48x48 LR crops, DUnet at num_feat 64, L1 + MS-SSIM +
    perceptual + GAN), the network cut to the tiny SwinIR and the batch to
    1: two steps, both learning rates and every log finite."""
    import cv2

    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.utils.options import parse_options

    from tests.test_torch_train import NET

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    (tmp_path / "hr").mkdir()
    (tmp_path / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        hr = (rng.random((192, 192, 3)) * 255).astype(np.uint8)
        lr = hr.reshape(48, 4, 48, 4, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(tmp_path / "hr" / f"img{i}.png"), hr)
        cv2.imwrite(str(tmp_path / "lr" / f"img{i}.png"), lr)
    cfg = yaml.safe_load((REPO / "configs/_templates/train/SwinIR/swinir_m_gan.yml").read_text())
    cfg["compute_dtype"] = "float32"
    cfg["network_g"] = dict(NET)
    cfg["datasets"] = {"train": {**cfg["datasets"]["train"],
                                 "dataroot_gt": str(tmp_path / "hr"),
                                 "dataroot_lq": str(tmp_path / "lr"),
                                 "batch_size_per_gpu": 1, "num_worker_per_gpu": 1}}
    cfg["train"]["total_iter"] = 2
    cfg["val"]["val_enabled"] = False
    cfg["logger"] = {"print_freq": 1, "save_checkpoint_freq": 1000, "use_tb_logger": False}
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])
    model = port_train.run(opt, device="cpu")
    assert type(model.net_d).__name__ == "DUnet" and model.step == 2
    log = model.get_current_log()
    for key in ("l_g_l1", "l_g_mssim", "l_g_perceptual", "l_g_gan", "l_d_real", "l_d_fake"):
        assert np.isfinite(log[key]), key
    assert model.get_current_learning_rate() == pytest.approx([2e-4, 2e-4])


@pytest.mark.parametrize("network_d", ["unetdiscriminatorsn", "vggstylediscriminator",
                                       "patchgandiscriminatorsn",
                                       "multiscalepatchgandiscriminatorsn"])
def test_other_discriminators_refuse_by_name(dataset, tmp_path, network_d):  # noqa: F811
    from trainner_redux_tpu_torch.models import build_model

    cfg = gan_config(dataset)
    cfg["network_d"] = {"type": network_d}
    _, opt = _opts(tmp_path, cfg)
    with pytest.raises(NotImplementedError, match=f"network_d type '{network_d}'"):
        build_model(opt, device="cpu")


@pytest.mark.parametrize(("change", "error", "match"), [
    ({"network_d": None}, ValueError, "GAN losses require network_d"),
    ({"losses": [{"type": "r3ganloss"}]}, NotImplementedError, "r3ganloss"),
    ({"losses": [{"type": "featurematchingloss"}]}, NotImplementedError, "featurematchingloss"),
])
def test_gan_refusals(dataset, tmp_path, change, error, match):  # noqa: F811
    from trainner_redux_tpu_torch.models import build_model

    cfg = gan_config(dataset)
    if "network_d" in change:
        cfg.pop("network_d")
    else:
        cfg["train"]["losses"] = change["losses"]
    _, opt = _opts(tmp_path, cfg)
    with pytest.raises(error, match=match):
        build_model(opt, device="cpu")
