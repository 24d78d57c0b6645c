"""The Real-ESRGAN on-the-fly (OTF) training slice, torch port vs JAX
package, on the CPU.

- the dataset: GT crops and the three 21x21 kernels bit for bit (seed 0,
  sinc_prob 0.3, final_sinc_prob 0.5; images larger and smaller than the
  gt_size + 32 crop; two epochs);
- the degradation sequence plans bit for bit, for every sequence set;
- the pair pool's fill and full steps, the JAX permutation handed to the
  port;
- `build_model` picks RealESRGANModel, or RealESRGANPairedModel when
  dataroot_lq_prob > 0, and the paired model takes the paired batch when
  its draw says so;
- the slice as a whole: a tiny SwinIR (embed 24, depths [2, 2], 3 heads,
  4x) on the deterministic OTF options (tests/test_torch_otf_degrade.py),
  queue_size 0, batch 2 of gt_size 32: `feed_data` and two
  `optimize_parameters` against the JAX `RealESRGANModel` from the same
  weights (JAX on its plain XLA path, as on a CPU it runs), the crop offsets
  from the JAX key: the LQ within 1/255, the losses within 1e-5 relative
  and the gradient norm too where the LQ is equal;
- the entry point `train.run` on the CPU (TRAINNER_PLATFORM=cpu), two steps
  at the probabilities of the SwinIR-M OTF template with the pool filling:
  shapes, the [0, 1] range and the 8-bit grid of the LQ, the checkpoints
  and the saved degradation generators.
"""

from pathlib import Path
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import NET, _opts, _to_port
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

SEED = 3
# every gate at 0 or 1, every range one point, one resize mode and one codec:
# the JAX key decides nothing but the crop (chromatic aberration's range
# and the noise are fixed in code or drawn, so they stay off)
DETERMINISTIC = {
    "lens_distort_prob": 1.0, "lens_distort_strength_range": [0.1, 0.1],
    "chromatic_aberration_prob": 0.0,
    "motion_blur_prob": 1.0, "motion_blur_angle_range": [30.0, 30.0],
    "motion_blur_kernel_size": [5, 7],
    "blur_prob": 1.0, "demosaic_prob": 1.0, "sensor_noise_prob": 0.0,
    "rolling_shutter_prob": 1.0, "rolling_shutter_strength_range": [0.05, 0.05],
    "gaussian_noise_prob": 0.0,
    "exposure_prob": 1.0, "exposure_factor_range": [1.2, 1.2],
    "color_temp_prob": 1.0, "color_temp_shift_range": [0.1, 0.1],
    "oversharpen_prob": 1.0, "oversharpen_strength": [1.5, 1.5],
    "aliasing_prob": 1.0, "aliasing_scale_range": [0.75, 0.75],
    "resize_mode_list3": ["bicubic"], "resize_mode_prob3": [1.0],
    "compression_formats": ["jpeg"], "compression_weights": [1.0],
    "compression_jpeg_range": [70.0, 70.0], "compression_webp_range": [70.0, 70.0],
    "compression_avif_range": [70.0, 70.0], "compression_heif_range": [70.0, 70.0],
    "recompression_prob": 1.0, "recompression_formats": ["jpeg"],
    "recompression_weights": [1.0],
    "editing_prob": 1.0, "editing_exposure_prob": 1.0, "editing_exposure_range": [0.9, 0.9],
    "editing_oversharpen_prob": 1.0, "editing_oversharpen_strength": [1.2, 1.2],
    "p_clean": 0.0,
}
# the probabilities configs/_templates/train/SwinIR/swinir_m_otf.yml sets
TEMPLATE = {"blur_prob": 0.8, "gaussian_noise_prob": 0.5, "noise_range": [1, 20],
            "jpeg_prob": 1.0, "compression_jpeg_range": [45, 95], "recompression_prob": 0.3}


@pytest.fixture(scope="module")
def gt_root(tmp_path_factory):
    """Four 80x80 GT images (cropped to 64x64) and one 50x60 (padded)."""
    import cv2

    root = tmp_path_factory.mktemp("otf_gt")
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(80, 80)] * 4 + [(50, 60)]):
        cv2.imwrite(str(root / f"g{i}.png"), (rng.random((*shape, 3)) * 255).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def jax_weights4(tmp_path_factory):
    """A JAX-framework safetensors of the tiny SwinIR at 4x, init plus
    noise."""
    from safetensors.numpy import save_file

    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    net = build_network({**NET, "scale": 4})
    params = net.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(params).items()}
    path = tmp_path_factory.mktemp("otf_weights") / "net_g.safetensors"
    save_file(flat, str(path), metadata={"framework": "trainner_redux_tpu", "arch": "swinir_m"})
    return path


def otf_config(gt_root: Path, weights: Path | None = None, **extra) -> dict:
    cfg = {
        "name": "torch_otf_parity", "scale": 4, "num_gpu": 1, "manual_seed": SEED,
        "compute_dtype": "float32", "mesh": {"data": 1},
        "network_g": dict(NET),
        "path": {"pretrain_network_g": str(weights), "strict_load_g": True} if weights else {},
        "high_order_degradation": True, "queue_size": 0,
        "datasets": {"train": {
            "name": "otf", "type": "realesrgandataset", "dataroot_gt": str(gt_root),
            "gt_size": 32, "batch_size_per_gpu": 2, "num_worker_per_gpu": 1,
            "sinc_prob": 0.3, "final_sinc_prob": 0.5,
        }},
        "train": {
            "total_iter": 2, "ema_decay": 0.999,
            "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
            "losses": [{"type": "l1loss", "loss_weight": 1.0}],
        },
        "logger": {"print_freq": 1, "save_checkpoint_freq": 1000, "use_tb_logger": False},
    }
    cfg.update(extra)
    return cfg


# ---------------------------------------------------------------------------
# the dataset and the sequence plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", [0, 2])
def test_dataset_matches_jax_bit_for_bit(gt_root, tmp_path, epoch):
    from trainner_redux_tpu.data import build_dataset as jbuild_dataset
    from trainner_redux_tpu.utils.config import Config as JConfig
    from trainner_redux_tpu_torch.data import build_dataset

    jopt, _ = _opts(tmp_path, otf_config(gt_root))
    jopt.manual_seed = 0  # the options parser takes a seed of 0 for "draw one"
    JConfig.set_config(jopt)  # the JAX dataset reads its seed from here
    try:
        jds = jbuild_dataset(jopt.datasets["train"])
        jds.set_epoch(epoch)
        want = [jds[i] for i in range(7)]  # 7 > 5: virtual indices too
    finally:
        JConfig.reset()
    ds = build_dataset(jopt.datasets["train"], seed=0)
    ds.set_epoch(epoch)
    sinc_drawn = 0
    for i, w in enumerate(want):
        g = ds[i]
        assert g["gt"].dtype == np.uint8 and g["gt"].shape == (64, 64, 3)
        for k in ("gt", "kernel1", "kernel2", "sinc_kernel"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} of sample {i}")
        assert g["gt_path"] == w["gt_path"]
        sinc_drawn += int(g["sinc_kernel"][10, 10] != 1.0)
    assert 0 < sinc_drawn < len(want)  # both final-sinc branches taken


def test_paired_dataset_matches_jax_bit_for_bit(gt_root, tmp_path):
    """RealESRGANPairedDataset: the OTF sample plus a paired LR/HR crop
    (gt_size 32 from 80x80 GT and their 20x20 LR)."""
    import cv2

    from trainner_redux_tpu.data import build_dataset as jbuild_dataset
    from trainner_redux_tpu.utils.config import Config as JConfig
    from trainner_redux_tpu_torch.data import build_dataset

    hr, lr = tmp_path / "hr", tmp_path / "lr"
    hr.mkdir()
    lr.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        img = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(hr / f"p{i}.png"), img)
        cv2.imwrite(str(lr / f"p{i}.png"), img.reshape(20, 4, 20, 4, 3).mean(axis=(1, 3))
                    .round().astype(np.uint8))
    cfg = otf_config(gt_root)
    cfg["datasets"]["train"].update(type="realesrganpaireddataset", dataroot_gt=str(hr),
                                    dataroot_lq=str(lr))
    jopt, _ = _opts(tmp_path, cfg)
    JConfig.set_config(jopt)
    try:
        want = [jbuild_dataset(jopt.datasets["train"])[i] for i in range(4)]
    finally:
        JConfig.reset()
    ds = build_dataset(jopt.datasets["train"], seed=jopt.manual_seed)
    for i, w in enumerate(want):
        g = ds[i]
        assert set(g) == set(w) and g["paired_lq"].shape == (8, 8, 3)
        for k in ("gt", "kernel1", "kernel2", "sinc_kernel", "paired_lq", "paired_gt"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} of sample {i}")


@pytest.mark.parametrize("name", ["photo", "video", "comprehensive", "all"])
def test_sequence_plans_match_jax(name):
    from trainner_redux_tpu.models import paragon_sequences as jseq
    from trainner_redux_tpu_torch.models import paragon_sequences as seq

    want_ctrl = jseq.SequenceController(jseq.sequences_for_set(name), seed=5)
    ctrl = seq.SequenceController(seq.sequences_for_set(name), seed=5)
    plans = [ctrl.plan() for _ in range(40)]
    assert plans == [want_ctrl.plan() for _ in range(40)]
    assert sum(bool(p) for p in plans) > 0


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_pool_step_matches_jax():
    from trainner_redux_tpu.models.realesrgan_model import RealESRGANModel as JaxModel
    from trainner_redux_tpu_torch.models.realesrgan_model import RealESRGANModel

    qs, b = 4, 2
    owner = types.SimpleNamespace(queue_size=qs)
    rng = np.random.default_rng(1)

    def arrays(*shape):
        return rng.random(shape).astype(np.float32)

    pool_lq, pool_gt = arrays(qs, 8, 8, 3), arrays(qs, 32, 32, 3)
    key = jax.random.key(7)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, qs)))
    for count in (0, 2, 4):
        lq, gt = arrays(b, 8, 8, 3), arrays(b, 32, 32, 3)
        want = JaxModel._pool_step(owner, jnp.asarray(pool_lq), jnp.asarray(pool_gt),
                                   jnp.int32(count), jnp.asarray(lq), jnp.asarray(gt), key)
        got = RealESRGANModel._pool_step(owner, torch.from_numpy(pool_lq.copy()),
                                         torch.from_numpy(pool_gt.copy()), count,
                                         torch.from_numpy(lq), torch.from_numpy(gt), perm)
        assert got[2] == int(want[2]) == (count + b if count < qs else count)
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# model selection
# ---------------------------------------------------------------------------


def test_build_model_picks_the_otf_models(gt_root, tmp_path):
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.models.realesrgan_model import (
        RealESRGANModel,
        RealESRGANPairedModel,
    )
    from trainner_redux_tpu_torch.models.sr_model import SRModel

    _, opt = _opts(tmp_path, otf_config(gt_root))
    model = build_model(opt, device="cpu")
    assert type(model) is RealESRGANModel
    _, opt = _opts(tmp_path, otf_config(gt_root, dataroot_lq_prob=1.0))
    paired = build_model(opt, device="cpu")
    assert type(paired) is RealESRGANPairedModel
    lq = np.full((2, 8, 8, 3), 7, np.uint8)
    paired.feed_data({"gt": np.zeros((2, 64, 64, 3), np.uint8), "paired_lq": lq,
                      "paired_gt": np.zeros((2, 32, 32, 3), np.uint8)})
    np.testing.assert_array_equal(paired.lq.numpy(), lq)  # the draw took the paired batch
    _, opt = _opts(tmp_path, otf_config(gt_root, high_order_degradation=False))
    assert type(build_model(opt, device="cpu")) is SRModel


def test_debug_dumps_stop_at_the_limit(gt_root, tmp_path, monkeypatch):
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.chdir(tmp_path)
    _, opt = _opts(tmp_path, otf_config(gt_root, high_order_degradations_debug=True,
                                        high_order_degradations_debug_limit=1))
    ds = build_dataset(opt.datasets["train"], seed=0)
    model = build_model(opt, device="cpu")
    batch = {k: np.stack([ds[i][k] for i in range(2)])
             for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
    for _ in range(2):
        model.feed_data(batch)
    import cv2

    assert sorted(p.name for p in (tmp_path / "debug" / "otf").iterdir()) == [
        "000001_otf_gt.png", "000001_otf_lq.png"]
    assert cv2.imread(str(tmp_path / "debug" / "otf" / "000001_otf_lq.png")).shape == (8, 16, 3)


def test_queue_size_must_split_into_batches(gt_root, tmp_path):
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.models import build_model

    _, opt = _opts(tmp_path, otf_config(gt_root, queue_size=3))
    ds = build_dataset(opt.datasets["train"], seed=0)
    model = build_model(opt, device="cpu")
    batch = {k: np.stack([ds[i][k] for i in range(2)])
             for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
    with pytest.raises(ValueError, match="multiple of batch"):
        model.feed_data(batch)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _jax_offsets(feed: int) -> tuple[int, int]:
    """The crop offsets the JAX program draws on feed `feed` (LQ 16x16,
    patch 8)."""
    key = jax.random.fold_in(jax.random.key(SEED + 7919), feed)
    k1, k2 = jax.random.split(jax.random.split(key, 48)[47])
    return tuple(int(jax.random.randint(k, (), 0, 16 - 8 + 1)) for k in (k1, k2))


def test_two_otf_steps_match_jax(gt_root, jax_weights4, tmp_path, monkeypatch):
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JBase
    from trainner_redux_tpu.models.realesrgan_model import RealESRGANModel as JaxModel
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    jopt, opt = _opts(tmp_path, otf_config(gt_root, jax_weights4, **DETERMINISTIC))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    assert isinstance(jmodel, JaxModel)

    want0 = _to_port(JBase.flatten_params(jmodel.state.params_g))
    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), want0[k], err_msg=k)

    ds = build_dataset(opt.datasets["train"], seed=SEED)
    for step in (1, 2):
        batch = {k: np.stack([ds[i][k] for i in (2 * step - 2, 2 * step - 1)])
                 for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}
        offsets = _jax_offsets(step)
        model._crop_offsets = lambda *_, o=offsets: o
        jmodel.feed_data(batch)
        model.feed_data(batch)
        assert model.lq.shape == (2, 8, 8, 3) and model.gt.shape == (2, 32, 32, 3)
        diff = np.abs(model.lq.numpy() - np.asarray(jmodel.lq))
        assert diff.max() <= 1 / 255
        np.testing.assert_allclose(model.gt.numpy(), np.asarray(jmodel.gt), rtol=0, atol=1e-7)
        jmodel.optimize_parameters(step)
        model.optimize_parameters(step)
        log, jlog = model.get_current_log(), jmodel.get_current_log()
        for key in ("l_g_l1", "l_g_total"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {step}")
        # an LQ pixel one 8-bit level apart (step 2 has one) moves the
        # gradient norm by about 4e-4; equal inputs hold it within 1e-5
        tol = 1e-5 if not (diff > 1e-6).any() else 1e-3
        np.testing.assert_allclose(log["grad_norm_g"], jlog["grad_norm_g"], rtol=tol,
                                   err_msg=f"grad_norm_g step {step}")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_train_run_on_the_template_probabilities(gt_root, tmp_path, monkeypatch):
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.utils.options import parse_options

    from tests.test_torch_train import _yaml

    monkeypatch.setenv("TRAINNER_PLATFORM", "cpu")
    cfg = otf_config(gt_root, queue_size=4, **TEMPLATE)
    cfg["logger"]["save_checkpoint_freq"] = 2
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])
    model = port_train.run(opt)
    assert model.step == 2 and model._feed_count == 2
    assert model._pool["count"] == 4  # two batches of 2 filled the pool
    lq, gt = model.lq.numpy(), model.gt.numpy()
    assert lq.shape == (2, 8, 8, 3) and gt.shape == (2, 32, 32, 3)
    assert lq.min() >= 0.0 and lq.max() <= 1.0 and np.isfinite(lq).all()
    np.testing.assert_allclose(lq * 255, np.round(lq * 255), rtol=0, atol=1e-3)
    exp = tmp_path / "experiments" / cfg["name"]
    assert (exp / "models" / "net_g_ema_2.safetensors").exists()
    state = torch.load(exp / "training_states" / "2.state", weights_only=True)
    assert state["otf_feed_count"] == 2
    assert torch.equal(state["otf_host_generator"], model.host_generator.get_state())


def test_template_mssim_refuses_the_gt_size_128_crop_in_both_packages():
    """swinir_m_otf.yml pairs mssimloss with gt_size 128: five scales of an
    11-tap window need 161 pixels a side, so both packages raise (the port
    says why); the OTF runs here train on L1."""
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu_torch.losses import build_loss

    x = np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        jbuild({"type": "mssimloss"})(jnp.asarray(x), jnp.asarray(x))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="161 pixels"):
        build_loss({"type": "mssimloss"})(t, t)
