"""The whole OTF degradation program with nothing drawn, torch port vs JAX
package, on the CPU.

Every gate is at probability 0 or 1, every range a single point, and the
resize-mode and codec weights one-hot, so the JAX program's key decides
nothing but the crop; the test recomputes the crop offsets from that key
(`keys[47]` of the JAX `_degrade`) and gives them to the port. The noise
operators and chromatic aberration, whose draws no option pins, are at
probability 0 here (tests/test_torch_degradations.py holds them on JAX's
noise). One batch of the port's dataset (bit-identical to the JAX one, 2 GT
crops of 64x64, scale 4) goes through both, once per resize mode and once
per codec, with the clean pass-through and with the compression stages
replaced by a sequence plan: the LQ within 1/255 on every pixel after the
8-bit rounding, the GT crop within 1e-7.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_realesrgan import DETERMINISTIC, gt_root, otf_config  # noqa: F401
from tests.test_torch_train import _opts
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

LQ_TOL = 1 / 255
KEYS = ("gt", "kernel1", "kernel2", "sinc_kernel")
SEED = 3


@pytest.fixture(scope="module")
def batch(gt_root, tmp_path_factory):  # noqa: F811
    from trainner_redux_tpu_torch.data import build_dataset

    _, opt = _opts(tmp_path_factory.mktemp("otf_batch"), otf_config(gt_root))
    ds = build_dataset(opt.datasets["train"], seed=SEED)
    return {k: np.stack([ds[i][k] for i in range(2)]) for k in KEYS}


def _run_both(tmp_path, gt_root, batch, plan=None, **options):  # noqa: F811
    """(port gt, port lq, JAX gt, JAX lq) of one feed's `_degrade`."""
    from trainner_redux_tpu.models.realesrgan_model import RealESRGANModel as JaxModel
    from trainner_redux_tpu_torch.models import build_model

    jopt, opt = _opts(tmp_path, otf_config(gt_root, **{**DETERMINISTIC, **options}))
    key = jax.random.fold_in(jax.random.key(SEED + 7919), 1)
    k1, k2 = jax.random.split(jax.random.split(key, 48)[47])
    offsets = tuple(int(jax.random.randint(k, (), 0, 16 - 8 + 1)) for k in (k1, k2))

    jself = types.SimpleNamespace(opt=jopt, scale=4, _op_jits={})
    degrade = jax.jit(lambda *a: JaxModel._degrade(jself, *a, skip_compression=bool(plan)))
    jgt, jlq = degrade(*(jnp.asarray(batch[k]) for k in KEYS), key)
    if plan:
        jlq = JaxModel._apply_plan(jself, jlq, plan, key)

    model = build_model(opt, device="cpu")
    model._crop_offsets = lambda *_: offsets
    with torch.no_grad():
        gt, lq = model._degrade(*(torch.from_numpy(batch[k]) for k in KEYS),
                                skip_compression=bool(plan))
        if plan:
            lq = model._apply_plan(lq, plan)
    return gt.numpy(), lq.numpy(), np.asarray(jgt), np.asarray(jlq)


def _check(got_gt, got_lq, want_gt, want_lq):
    assert got_lq.shape == want_lq.shape == (2, 8, 8, 3)
    assert got_gt.shape == want_gt.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got_gt, want_gt, rtol=0, atol=1e-7)
    assert np.abs(got_lq - want_lq).max() <= LQ_TOL
    np.testing.assert_allclose(got_lq * 255, np.round(got_lq * 255), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest", "nearest-exact", "area",
                                  "lanczos"])
def test_degrade_per_resize_mode_matches_jax(mode, tmp_path, gt_root, batch):  # noqa: F811
    _check(*_run_both(tmp_path, gt_root, batch, resize_mode_list3=[mode],
                      resize_mode_prob3=[1.0]))


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif", "heif"])
def test_degrade_per_codec_matches_jax(codec, tmp_path, gt_root, batch):  # noqa: F811
    _check(*_run_both(tmp_path, gt_root, batch, compression_formats=[codec],
                      compression_weights=[1.0], recompression_formats=[codec],
                      recompression_weights=[1.0]))


def test_clean_pass_through_matches_jax(tmp_path, gt_root, batch):  # noqa: F811
    _check(*_run_both(tmp_path, gt_root, batch, p_clean=1.0))


def test_sequence_plan_matches_jax(tmp_path, gt_root, batch):  # noqa: F811
    """The compression stages replaced by a plan of every op that draws
    nothing, in upstream's vocabulary."""
    plan = [("lens_distortion", {"strength": 0.05}), ("chromatic_aberration", {"strength": 1.5}),
            ("demosaicing", {}), ("blur", {"sigma": 0.8}),
            ("motion_blur", {"kernel_size": 5, "angle": 20.0}),
            ("rolling_shutter", {"strength": 0.03}), ("exposure_error", {"factor": 1.1}),
            ("color_temp_shift", {"shift": -0.1}), ("oversharpening", {"strength": 1.3}),
            ("jpeg_compression", {"quality": 60.0}), ("webp_compression", {"quality": 80.0}),
            ("ringing", {"strength": 0.05}), ("video_compression", {"crf": 24.0}),
            ("color_banding", {"bits": 6})]
    _check(*_run_both(tmp_path, gt_root, batch, plan=plan))
