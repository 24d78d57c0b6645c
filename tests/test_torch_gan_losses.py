"""The port's GAN, perceptual and pixel-criterion losses vs the JAX
package's, on the CPU, from numpy-seeded inputs.

- GANLoss: each of the five gan_types, on real and fake targets, in the
  generator's and the discriminator's form, value and gradient within
  1e-5; the multi-scale form (a list of scales, each a list whose last
  entry is taken);
- the VGG feature extractor: VGG19 and VGG16 from the seeded random init,
  whose weights are bit-identical to the JAX package's, every conv tap
  (before the ReLU) and relu tap (after it) within 1e-4 of its largest,
  with and without input and range normalisation, cut after the deepest
  requested layer; the refusal without weights;
- PerceptualLoss (VGG19, the default layer weights) with each criterion
  (l1, l2, charbonnier, huber, fro) and with the style term: the value and
  the gradient of the prediction within 1e-4; the target takes no
  gradient;
- get_criterion's criteria; the losses left out refuse by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _close(got, want, what: str, tol: float = 1e-5) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), f"{what}: {err:.3g}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# GANLoss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_disc", [False, True])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"])
def test_gan_loss_matches_jax(gan_type, real, is_disc):
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu_torch.losses import build_loss

    opt = {"type": "ganloss", "gan_type": gan_type, "loss_weight": 0.1}
    pred = (np.random.default_rng(0).standard_normal((2, 8, 8, 1)) * 3).astype(np.float32)
    jloss = jbuild(opt)
    want, dwant = jax.value_and_grad(lambda p: jloss(p, real, is_disc=is_disc))(
        jnp.asarray(pred))
    pt = _nchw(pred).requires_grad_(True)
    got = build_loss(opt)(pt, real, is_disc=is_disc)
    got.backward()
    _close(got.item(), want, "value")
    _close(pt.grad.numpy().transpose(0, 2, 3, 1), dwant, "gradient")


@pytest.mark.parametrize("loss_type", ["multiscaleganloss", "ganloss"])
def test_multiscale_gan_loss_matches_jax(loss_type):
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu_torch.losses import build_loss

    rng = np.random.default_rng(1)
    preds = [rng.standard_normal((2, s, s, 1)).astype(np.float32) for s in (8, 4)]
    opt = {"type": loss_type, "gan_type": "lsgan"}
    # scale 0 a bare map, scale 1 a list of features whose last is the map
    jpreds = [jnp.asarray(preds[0]), [jnp.zeros((2, 4, 4, 3)), jnp.asarray(preds[1])]]
    tpreds = [_nchw(preds[0]), [torch.zeros(2, 3, 4, 4), _nchw(preds[1])]]
    for real in (True, False):
        want = jbuild(opt)(jpreds, real, is_disc=True)
        got = build_loss(opt)(tpreds, real, is_disc=True)
        _close(got.item(), want, f"real={real}")


def test_gan_loss_refuses_an_unknown_type():
    from trainner_redux_tpu_torch.losses import build_loss

    with pytest.raises(NotImplementedError, match="ragan"):
        build_loss({"type": "ganloss", "gan_type": "ragan"})


@pytest.mark.parametrize("loss_type", ["r3ganloss", "multiscaler3ganloss",
                                       "featurematchingloss"])
def test_losses_left_out_refuse_by_name(loss_type):
    from trainner_redux_tpu_torch.losses import build_loss

    with pytest.raises(NotImplementedError, match=f"'{loss_type}' is not ported"):
        build_loss({"type": loss_type})


# ---------------------------------------------------------------------------
# the VGG feature extractor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(("vgg_type", "layers", "input_norm", "range_norm"), [
    ("vgg19", ["conv1_2", "relu2_2", "conv3_4", "relu4_4", "conv5_4"], True, False),
    ("vgg16", ["relu1_1", "conv2_2", "conv3_3", "relu3_3"], False, True),
])
def test_vgg_taps_match_jax(vgg_type, layers, input_norm, range_norm):
    from trainner_redux_tpu.archs.vgg_arch import VGGFeatureExtractor as JaxVGG
    from trainner_redux_tpu_torch.archs.vgg_arch import VGGFeatureExtractor

    jvgg = JaxVGG(layers, vgg_type, input_norm, range_norm, allow_random_init=True)
    vgg = VGGFeatureExtractor(layers, vgg_type, input_norm, range_norm, allow_random_init=True)
    # the random init, bit for bit, and the cut after the deepest layer
    convs = [m for m in vgg.features if isinstance(m, torch.nn.Conv2d)]
    assert [n for n, _ in jvgg.cfg if n.startswith("conv")] == [
        n for n in vgg.names if n.startswith("conv")]
    for (name, p), m in zip(((n, jvgg.params[n]) for n in jvgg.params), convs):
        np.testing.assert_array_equal(m.weight.numpy().transpose(2, 3, 1, 0),
                                      np.asarray(p["kernel"]), err_msg=name)
        np.testing.assert_array_equal(m.bias.numpy(), np.asarray(p["bias"]), err_msg=name)
    assert not any(p.requires_grad for p in vgg.parameters())

    x = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
    if range_norm:
        x = x * 2 - 1
    want = jvgg(jnp.asarray(x))
    got = vgg(_nchw(x))
    assert set(got) == set(want) == set(layers)
    for k in layers:
        _close(got[k].numpy().transpose(0, 2, 3, 1), want[k], k, 1e-4)


def test_vgg_refuses_without_weights(monkeypatch):
    from trainner_redux_tpu_torch.archs.vgg_arch import VGGFeatureExtractor

    monkeypatch.delenv("TRAINNER_ALLOW_RANDOM_VGG", raising=False)
    monkeypatch.delenv("TRAINNER_WEIGHTS_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="vgg19 weights not found"):
        VGGFeatureExtractor(["conv1_1"])


def test_vgg_reads_torchvision_weights(tmp_path, monkeypatch):
    """A torchvision-layout state dict (`features.<i>.weight`, classifier
    keys beside) under $TRAINNER_WEIGHTS_DIR is loaded, not the random
    init."""
    from trainner_redux_tpu_torch.archs.vgg_arch import VGGFeatureExtractor

    monkeypatch.delenv("TRAINNER_ALLOW_RANDOM_VGG", raising=False)
    rng = np.random.default_rng(3)
    sd = {"features.0.weight": rng.standard_normal((64, 3, 3, 3)),
          "features.0.bias": rng.standard_normal(64),
          "features.2.weight": rng.standard_normal((64, 64, 3, 3)),
          "features.2.bias": rng.standard_normal(64),
          "classifier.0.weight": rng.standard_normal((4, 4))}
    torch.save({k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()},
               tmp_path / "vgg16.pth")
    monkeypatch.setenv("TRAINNER_WEIGHTS_DIR", str(tmp_path))
    vgg = VGGFeatureExtractor(["relu1_2"], "vgg16")
    np.testing.assert_array_equal(vgg.features[2].weight.numpy(),
                                  sd["features.2.weight"].astype(np.float32))
    assert len(vgg.features) == 4


# ---------------------------------------------------------------------------
# PerceptualLoss and the criteria
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(("criterion", "style"), [
    ("l1", 0.0), ("l2", 0.0), ("charbonnier", 0.0), ("huber", 0.0), ("fro", 0.0),
    ("l1", 0.5),
])
def test_perceptual_loss_matches_jax(criterion, style):
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu_torch.losses import build_loss

    opt = {"type": "perceptualloss", "loss_weight": 0.7, "criterion": criterion,
           "style_weight": style}
    if criterion == "huber":
        # huber's delta 1 cuts through these features' differences
        opt["layer_weights"] = {"conv1_2": 1.0, "relu3_4": 0.5}
    rng = np.random.default_rng(4)
    pred, gt = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jloss = jbuild(opt)
    want, dwant = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(gt)))(jnp.asarray(pred))
    pt, gtt = _nchw(pred).requires_grad_(True), _nchw(gt).requires_grad_(True)
    got = build_loss(opt)(pt, gtt)
    got.backward()
    _close(got.item(), want, "value", 1e-4)
    _close(pt.grad.numpy().transpose(0, 2, 3, 1), dwant, "gradient", 1e-4)
    assert gtt.grad is None


def test_perceptualfp16loss_is_the_same_loss():
    from trainner_redux_tpu_torch.losses import build_loss
    from trainner_redux_tpu_torch.losses.perceptual_loss import PerceptualLoss

    assert isinstance(build_loss({"type": "perceptualfp16loss"}), PerceptualLoss)


@pytest.mark.parametrize("name", ["l1", "l2", "mse", "charbonnier", "huber"])
def test_criteria_match_jax(name):
    from trainner_redux_tpu.losses.loss_util import get_criterion as jget
    from trainner_redux_tpu_torch.losses.loss_util import get_criterion

    rng = np.random.default_rng(5)
    a, b = ((rng.standard_normal((2, 3, 8, 8)) * 2).astype(np.float32) for _ in range(2))
    _close(get_criterion(name)(torch.from_numpy(a), torch.from_numpy(b)).item(),
           jget(name)(jnp.asarray(a), jnp.asarray(b)), name)
    with pytest.raises(NotImplementedError, match="ssim"):
        get_criterion("ssim")
