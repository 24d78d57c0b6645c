"""The port's SpanC (SPAN++) against the JAX package's, on the CPU, by the
checks of tests/test_torch_span.py: the spanc / spanpp presets' parameters
through the bridge; a tiny SpanC (16 channels, IGConv's implicit width 16,
two latent layers) at 4x on 12x20 LR images, fp32 forwards in train mode (RepConv's
SeqConv3x3 and Conv3XC chains) and eval mode (each folded to one 3x3)
within 1e-4 of the output's largest and L1 gradients within 1e-4 of each
tensor's largest; in bf16 against flax's bf16 (output 2e-2, gradients
against fp32 at 2x flax's distance in L2); the golden `spanpp` fixture
(with upstream's `conv_3x3_rep` and `eval_conv` copies, dropped on load)
through `SRModel.load_network`, strict.
"""

import pytest

from tests.test_torch_span import GOLDEN_ARCH, GOLDEN_NETS, NETS, check_bf16, check_fp32, \
    check_golden, check_preset
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("preset", ["spanc", "spanpp"])
def test_presets_match_jax_param_shapes(preset):
    check_preset(preset)


def test_spanc_matches_jax():
    net_opt, arch = NETS["spanc"]
    check_fp32(net_opt, arch, 4, 12, 20)


def test_spanc_bf16_matches_flax():
    net_opt, arch = NETS["spanc"]
    check_bf16(net_opt, arch, 2)


def test_golden_fixture_through_load_network(tmp_path):
    check_golden(tmp_path, "spanpp", GOLDEN_NETS["spanpp"], GOLDEN_ARCH["spanpp"])
