"""The on-device degradation operators, torch port vs JAX package, on the
CPU, at B=2 and 24x24 (fp32).

Each operator takes the same seeded inputs in both packages. Where the JAX
operator draws from its key (the noise, the aliasing bucket, the crop
offsets, a codec's quality), the test draws from that key with JAX and
hands the draws to the port. Tolerances: 1e-5 absolute for the resampling
and pixel operators; 1e-4 for those that run DiffJPEG (its tolerance);
quantising operators (8-bit rounding, block artifacts, banding) must agree
exactly on the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

TOL = 1e-5
JPEG_TOL = 1e-4
B, H, W = 2, 24, 24


def _img(seed: int = 0, shape=(B, H, W, 3)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _jt(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

MODES = ["bilinear", "bicubic", "nearest", "nearest-exact", "area", "lanczos"]


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("size", [(10, 13), (37, 30)], ids=["down", "up"])
@pytest.mark.parametrize("mode", MODES)
def test_resize_matches_jax(mode, size, antialias):
    from trainner_redux_tpu.ops.resize import resize as jax_resize
    from trainner_redux_tpu_torch.ops.resize import resize

    j, t = _jt(_img(1))
    _close(resize(t, size, mode=mode, antialias=antialias),
           jax_resize(j, size, mode=mode, antialias=antialias))


@pytest.mark.parametrize(("ksize", "sigma"), [(5, 1.0), (7, 1.3), (13, 13 / 6)])
def test_gaussian_blur_matches_jax(ksize, sigma):
    from trainner_redux_tpu.ops.resize import gaussian_blur as jax_blur
    from trainner_redux_tpu_torch.ops.resize import gaussian_blur

    j, t = _jt(_img(2))
    _close(gaussian_blur(t, ksize, sigma), jax_blur(j, ksize, sigma))


def _kernels21(seed: int) -> np.ndarray:
    """Two per-sample 21x21 blur kernels as the dataset draws them."""
    from trainner_redux_tpu_torch.data.degradation_kernels import random_mixed_kernels

    rng = np.random.default_rng(seed)
    out = []
    for size in (21, 15):
        k = random_mixed_kernels(rng, ["iso", "aniso", "generalized_iso", "plateau_aniso"],
                                 [0.3, 0.3, 0.2, 0.2], size, (0.2, 3), (0.2, 3),
                                 (-np.pi, np.pi), (0.5, 4), (1, 2), noise_range=None)
        pad = (21 - size) // 2
        out.append(np.pad(k, pad).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("per_sample", [True, False])
def test_filter2d_matches_jax(per_sample):
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    kernels = _kernels21(3)
    if not per_sample:
        kernels = kernels[0]
    j, t = _jt(_img(3))
    jk, tk = _jt(kernels)
    _close(D.filter2d(t, tk), JD.filter2d(j, jk))


def test_bilinear_sample_matches_jax():
    from trainner_redux_tpu.archs.arch_util import bilinear_sample as jax_sample
    from trainner_redux_tpu_torch.archs.arch_util import bilinear_sample

    rng = np.random.default_rng(4)
    j, t = _jt(_img(4))
    cy, cx = (rng.uniform(-2, 26, (B, 17, 19)).astype(np.float32) for _ in range(2))
    _close(bilinear_sample(t, torch.from_numpy(cy), torch.from_numpy(cx)),
           jax_sample(j, jnp.asarray(cy), jnp.asarray(cx)))


# ---------------------------------------------------------------------------
# optics, sensor, ISP
# ---------------------------------------------------------------------------

# name -> (per-sample parameter shape, its range)
PARAM_OPS = {
    "apply_lens_distortion": ((B,), (-0.3, 0.3)),
    "apply_chromatic_aberration": ((B,), (0.5, 2.0)),
    "apply_rolling_shutter": ((B, 1), (-0.1, 0.1)),
    "apply_exposure": ((B, 1, 1, 1), (0.5, 2.0)),
    "apply_color_temperature": ((B, 1, 1), (-0.2, 0.2)),
    "apply_oversharpen": ((B, 1, 1, 1), (1.0, 2.0)),
}


@pytest.mark.parametrize("name", sorted(PARAM_OPS))
def test_parametric_ops_match_jax(name):
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    shape, (lo, hi) = PARAM_OPS[name]
    rng = np.random.default_rng(5)
    j, t = _jt(_img(5))
    jp, tp = _jt(rng.uniform(lo, hi, shape).astype(np.float32))
    _close(getattr(D, name)(t, tp), getattr(JD, name)(j, jp))


def test_demosaic_matches_jax():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(6))
    _close(D.apply_demosaic_artifacts(t), JD.apply_demosaic_artifacts(j))


@pytest.mark.parametrize("angle", [[0.0, 37.5], [90.0, 301.0]])
def test_motion_blur_kernel_matches_jax(angle):
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    a = np.asarray(angle, np.float32)
    want = jax.vmap(lambda x: JD.motion_blur_kernel(None, 9, x))(jnp.asarray(a))
    _close(D.motion_blur_kernel(9, torch.from_numpy(a)), want)
    _close(D.motion_blur_kernel(9, torch.tensor(a[1])), JD.motion_blur_kernel(None, 9, a[1]))


@pytest.mark.parametrize("bucket", range(4))
def test_aliasing_bucket_matches_jax(bucket):
    """The JAX operator draws its bucket from the key: take a key that
    draws `bucket` and hand the port the bucket."""
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    key = next(k for k in (jax.random.key(i) for i in range(64))
               if int(jax.random.randint(k, (), 0, D.ALIASING_BUCKETS)) == bucket)
    j, t = _jt(_img(7))
    _close(D.apply_aliasing(t, (0.3, 0.9), bucket), JD.apply_aliasing(j, key, (0.3, 0.9)))


def test_usm_sharpen_matches_jax():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(8))
    _close(D.usm_sharpen(t, 0.5, 7), JD.usm_sharpen(j, 0.5, 7))


# ---------------------------------------------------------------------------
# noise: the JAX key's draws handed to the port
# ---------------------------------------------------------------------------


def test_gaussian_and_poisson_noise_match_jax():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(9))
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    noise_c = torch.from_numpy(np.array(jax.random.normal(k1, j.shape)))
    noise_g = torch.from_numpy(np.array(jax.random.normal(k2, (B, H, W, 1))))
    sigma = np.asarray([5 / 255, 20 / 255], np.float32)
    gray = np.asarray([False, True])
    _close(D.add_gaussian_noise(t, noise_c, noise_g, torch.from_numpy(sigma),
                                torch.from_numpy(gray)),
           JD.add_gaussian_noise(j, key, jnp.asarray(sigma), jnp.asarray(gray)))
    scale = np.asarray([1.0, 2.5], np.float32)
    _close(D.add_poisson_noise(t, noise_c, noise_g, torch.from_numpy(scale),
                               torch.from_numpy(gray)),
           JD.add_poisson_noise(j, key, jnp.asarray(scale), jnp.asarray(gray)))


def test_sensor_noise_matches_jax():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(10))
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    shot, read = (torch.from_numpy(np.array(jax.random.normal(k, j.shape))) for k in (k1, k2))
    std = np.asarray([0.01, 0.1], np.float32).reshape(B, 1, 1, 1)
    _close(D.apply_sensor_noise(t, shot, read, torch.from_numpy(std)),
           JD.apply_sensor_noise(j, key, jnp.asarray(std)))


# ---------------------------------------------------------------------------
# quantisers, the crop, the codec surrogates
# ---------------------------------------------------------------------------


def test_round_to_uint8_matches_jax_exactly():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    x = _img(11) * 1.2 - 0.1
    x[0, 0, :4, 0] = np.asarray([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0  # ties
    j, t = _jt(x)
    np.testing.assert_array_equal(D.round_to_uint8(t).numpy(), np.asarray(JD.round_to_uint8(j)))


@pytest.mark.parametrize(("name", "arg"), [("apply_block_artifacts", 12.0),
                                           ("apply_color_banding", 5.0),
                                           ("apply_ringing", 0.3)])
def test_codec_artifact_ops_match_jax(name, arg):
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(12))
    got = getattr(D, name)(t, arg)
    want = getattr(JD, name)(j, jnp.float32(arg))
    if name == "apply_ringing":
        _close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paired_crop_at_jax_offsets():
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    gt, lq = _img(13, (B, 48, 48, 3)), _img(14, (B, 12, 12, 3))
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    top, left = (int(jax.random.randint(k, (), 0, 12 - 8 + 1)) for k in (k1, k2))
    want_gt, want_lq = JD.paired_random_crop_device(jnp.asarray(gt), jnp.asarray(lq), key, 32, 4)
    got_gt, got_lq = D.paired_random_crop_device(torch.from_numpy(gt), torch.from_numpy(lq),
                                                 32, 4, top, left)
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    np.testing.assert_array_equal(got_lq.numpy(), np.asarray(want_lq))


@pytest.mark.parametrize("offset", [0.0, 5.0, 10.0])
def test_compress_jpeg_like_matches_jax(offset):
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(15))
    key = jax.random.key(6)
    q = np.array(jax.random.uniform(key, (B,), minval=45, maxval=95))
    _close(D.compress_jpeg_like(t, torch.from_numpy(q), offset),
           JD.compress_jpeg_like(j, key, (45, 95), offset), JPEG_TOL)
    _close(D.diff_jpeg_clip(t, torch.from_numpy(q)), JD.diff_jpeg_clip(j, jnp.asarray(q)),
           JPEG_TOL)


@pytest.mark.parametrize("crf", [18.0, 35.0])
def test_video_codec_surrogate_matches_jax(crf):
    """DiffJPEG then the block quantiser: within DiffJPEG's tolerance a
    pixel may land on the other side of a quantisation step, so the two
    agree within 1e-4 except at such pixels, which are counted (none
    here)."""
    from trainner_redux_tpu.ops import degradations as JD
    from trainner_redux_tpu_torch.ops import degradations as D

    j, t = _jt(_img(16))
    got = D.apply_video_codec_artifacts(t, crf).numpy()
    want = np.asarray(JD.apply_video_codec_artifacts(j, jax.random.key(0), jnp.float32(crf)))
    off_step = np.abs(got - want) > JPEG_TOL
    assert off_step.sum() == 0, f"{off_step.sum()} pixels a quantisation step apart"
