"""The port's `hsluvloss` and `cosimloss` against the JAX package's, on the
CPU: on NCHW images (the port's layout; the JAX losses take NHWC), each
option of hsluv (criterion l1, charbonnier and l2, downscale_factor,
blur_strength, the three component weights, loss_weight) and cosim's
lambda, every value (hsluv's three terms each) within 1e-5 and the
gradient with respect to the output within 1e-5 of its largest. The images
are in (0, 1) with saturated and dark pixels among them (where hsluv's hue
and saturation gates switch), and a pure grey pixel (zero chroma). There
the JAX hsluv loss's gradient is NaN (atan2 and hypot differentiated at
u = v = 0; ROADMAP.md section 3): the port's must be finite there, and is
held to JAX's everywhere else. The two losses through a training step:
tests/test_torch_conv_loss_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-5  # of the largest |gradient|
GREY = (1, 5, 5)  # (image, row, column) of the grey pixel


def _images(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.02, 0.98, (2, 16, 16, 3)).astype(np.float32)
    x[0, :4, :4] = rng.uniform(0.0, 0.05, (4, 4, 3))  # dark: the lightness gates
    # saturated, off pure red's hue (G = B there), which a clipped GT pixel
    # has too, and |x_h - y_h| = 0 would sit on abs's kink
    x[1, :4, :4] = [0.95, 0.05, 0.12]
    x[GREY[0], GREY[1], GREY[2]] = 0.5  # grey: zero chroma
    y = np.clip(x + rng.normal(0, 0.08, x.shape), 0, 1).astype(np.float32)
    return x, y


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _check(jloss, tloss) -> None:
    x, y = _images()

    def jtotal(a):
        v = jloss(a, jnp.asarray(y))
        return sum(v.values()) if isinstance(v, dict) else v

    jval = jloss(jnp.asarray(x), jnp.asarray(y))
    jgrad = np.asarray(jax.grad(jtotal)(jnp.asarray(x))).transpose(0, 3, 1, 2)
    xt = _nchw(x).requires_grad_(True)
    tval = tloss(xt, _nchw(y))
    total = sum(tval.values()) if isinstance(tval, dict) else tval
    total.backward()
    if isinstance(jval, dict):
        assert tval.keys() == jval.keys() == {"hue", "saturation", "lightness"}
        for k in jval:
            assert abs(float(tval[k]) - float(jval[k])) <= VALUE_TOL, k
    else:
        assert abs(float(tval) - float(jval)) <= VALUE_TOL
    got = xt.grad.numpy()
    assert np.isfinite(got).all()
    defined = np.isfinite(jgrad)
    undefined = {tuple(i) for i in np.argwhere(~defined.all(axis=1))}
    assert undefined <= {GREY}, f"JAX NaN gradients off the grey pixel: {undefined}"
    err, top = np.abs(got - jgrad)[defined].max(), np.abs(jgrad[defined]).max()
    assert err <= GRAD_TOL * top, f"grad max|diff| {err:.3g} vs max {top:.3g}"


@pytest.mark.parametrize("opts", [
    {},
    {"criterion": "charbonnier"},
    {"criterion": "l2", "loss_weight": 0.5},
    {"downscale_factor": 2},
    {"blur_strength": 1},
    {"criterion": "charbonnier", "downscale_factor": 2, "blur_strength": 1},
    {"hue_weight": 0.5, "saturation_weight": 0.2, "lightness_weight": 0.3},
])
def test_hsluv_loss_matches_jax(opts):
    from trainner_redux_tpu.losses.hsluv_loss import HSLuvLoss as JaxHSLuv
    from trainner_redux_tpu_torch.losses import build_loss

    _check(JaxHSLuv(**opts), build_loss({"type": "hsluvloss", **opts}))


@pytest.mark.parametrize("opts", [{}, {"cosim_lambda": 2.0, "loss_weight": 0.5}])
def test_cosim_loss_matches_jax(opts):
    from trainner_redux_tpu.losses.misc_losses_loss import CosimLoss as JaxCosim
    from trainner_redux_tpu_torch.losses import build_loss

    _check(JaxCosim(**opts), build_loss({"type": "cosimloss", **opts}))


def test_rgb_to_hsluv_matches_jax():
    """The colour conversion itself, HSLuv of every pixel within 1e-3 of
    the JAX function's (H in degrees, S and L in 0-100)."""
    from trainner_redux_tpu.utils.hsluv import rgb_to_hsluv as jax_hsluv
    from trainner_redux_tpu_torch.utils.hsluv import rgb_to_hsluv

    x, _ = _images(3)
    want = np.asarray(jax_hsluv(jnp.asarray(x)))
    got = rgb_to_hsluv(torch.from_numpy(x)).numpy()
    # hue is circular: 0 and 360 are one hue
    dh = np.abs(got[..., 0] - want[..., 0])
    assert np.minimum(dh, 360.0 - dh).max() <= 1e-3
    assert np.abs(got[..., 1:] - want[..., 1:]).max() <= 1e-3


def test_grey_and_black_pixel_gradients_finite_where_jax_is_nan():
    """A fault of the JAX package (ROADMAP.md section 3): its hsluv loss's
    gradient is NaN at an output pixel with R = G = B (grey; an output
    clipped to white in every channel is one) and at one at or below 0 in
    every channel (black after the clip: the u'v' divider is 0); the
    port's is finite at both."""
    from trainner_redux_tpu.losses.hsluv_loss import HSLuvLoss as JaxHSLuv
    from trainner_redux_tpu_torch.losses import build_loss

    x, y = _images()
    black = (0, 10, 10)
    x[black] = [0.0, -0.2, -0.05]
    jgrad = np.asarray(jax.grad(lambda a: sum(JaxHSLuv()(a, jnp.asarray(y)).values()))(
        jnp.asarray(x)))
    assert np.isnan(jgrad[GREY]).all() and np.isnan(jgrad[black]).all()
    xt = _nchw(x).requires_grad_(True)
    sum(build_loss({"type": "hsluvloss"})(xt, _nchw(y)).values()).backward()
    assert np.isfinite(xt.grad.numpy()).all()
