"""The port's SPANPlus against the JAX package's, on the CPU, by the checks
of tests/test_torch_span.py: the four presets' parameters through the
bridge; a tiny SPANPlus (16 channels, one stage of one block) with the
DySample upsampler and its 1x1 end convolution (the local sampler, radius
2) at 2x and with the pixel shuffle at 4x, fp32 forwards in train
and eval mode within 1e-4 of the output's largest and L1 gradients within
1e-4 of each tensor's largest; the DySample network in bf16 against flax's
bf16 (output 2e-2, gradients against fp32 at 2x flax's distance in L2);
the golden `spanplus` fixture through `SRModel.load_network`, strict.
"""

import pytest

from tests.test_torch_span import GOLDEN_ARCH, GOLDEN_NETS, NETS, check_bf16, check_fp32, \
    check_golden, check_preset
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("preset", ["spanplus", "spanplus_s", "spanplus_st", "spanplus_sts"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


@pytest.mark.parametrize("name,scale,h,w", [("spanplus_dys", 2, 12, 20),
                                            ("spanplus_ps", 4, 12, 20)])
def test_spanplus_matches_jax(name, scale, h, w):
    net_opt, arch = NETS[name]
    check_fp32(net_opt, arch, scale, h, w)


def test_spanplus_bf16_matches_flax():
    net_opt, arch = NETS["spanplus_dys"]
    check_bf16(net_opt, arch, 2)


def test_golden_fixture_through_load_network(tmp_path):
    check_golden(tmp_path, "spanplus", GOLDEN_NETS["spanplus"], GOLDEN_ARCH["spanplus"])
