"""The port's Compact (SRVGGNetCompact) and ESRGAN (RRDBNet) against the JAX
package's, on the CPU, by the checks of tests/test_torch_span.py:

- the presets compact, ultracompact, superultracompact, srvggnetcompact,
  esrgan and esrgan_lite have the JAX presets' parameters through the
  bridge (keys and shapes);
- a tiny Compact (8 features, 2 convolutions; PReLU at 4x, LeakyReLU at
  2x) and a tiny ESRGAN (8 filters, 1 or 2 RRDBs) at 4x, and at 1x and
  2x, whose inputs (13x14, 10x11) need the reflect pad before the
  pixel-unshuffle and the crop after: fp32 forwards within 1e-4 of the
  output's largest and L1 gradients within 1e-4 of each tensor's largest;
- both in bf16 against flax's bf16 (output 2e-2, gradients against fp32 at
  2x flax's distance in L2);
- the golden `srvgg` fixture through `SRModel.load_network`, strict (ESRGAN
  has no fixture: it is held against the JAX package above);
- `esrgan(scale=3)`: the port refuses it, naming why, and the same call
  fails in the JAX package (flax's NameInUseError: `conv_up1` declared
  twice, rrdbnet_arch.py:104-110).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_span import check_bf16, check_fp32, check_golden, check_preset
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu_torch.archs import build_network

COMPACT = {"type": "compact", "num_feat": 8, "num_conv": 2}
ESRGAN = {"type": "esrgan", "num_filters": 8, "num_blocks": 1}


@pytest.mark.parametrize("preset", ["compact", "ultracompact", "superultracompact",
                                    "srvggnetcompact", "esrgan", "esrgan_lite"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


@pytest.mark.parametrize("net_opt,scale", [(COMPACT, 4),
                                           ({**COMPACT, "act_type": "leakyrelu"}, 2)])
def test_compact_matches_jax(net_opt, scale):
    check_fp32(net_opt, "SRVGGNetCompact", scale, 12, 20)


@pytest.mark.parametrize("scale,h,w,blocks", [(4, 12, 16, 2), (2, 13, 14, 1), (1, 10, 11, 1)])
def test_esrgan_matches_jax(scale, h, w, blocks):
    check_fp32({**ESRGAN, "num_blocks": blocks}, "RRDBNet", scale, h, w)


@pytest.mark.parametrize("net_opt,arch,scale", [(COMPACT, "SRVGGNetCompact", 4),
                                                (ESRGAN, "RRDBNet", 4), (ESRGAN, "RRDBNet", 2)])
def test_bf16_matches_flax(net_opt, arch, scale):
    check_bf16(net_opt, arch, scale)


def test_golden_srvgg_fixture_through_load_network(tmp_path):
    check_golden(tmp_path, "srvgg", {"type": "compact", "scale": 2, "num_feat": 8,
                                     "num_conv": 2}, "SRVGGNetCompact")


def test_esrgan_scale_3_refused():
    from trainner_redux_tpu.archs import build_network as jax_build_network

    with pytest.raises(ValueError, match="scale 3.*conv_up1 twice.*NameInUseError"):
        build_network({**ESRGAN, "scale": 3})
    jnet = jax_build_network({**ESRGAN, "scale": 3})
    with pytest.raises(Exception, match="conv_up1") as info:
        jnet.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    assert type(info.value).__name__ == "NameInUseError"
    for scale in (1, 2, 4):  # the scales the JAX package builds, the port too
        out = build_network({**ESRGAN, "scale": scale}).eval()(torch.zeros(1, 3, 9, 10))
        assert tuple(out.shape) == (1, 3, 9 * scale, 10 * scale)
    assert np.isfinite(out.detach().numpy()).all()
