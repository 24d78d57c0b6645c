"""DRCT in bf16 on the CPU, and its 9 training templates.

- the golden `drct` config (tests/test_torch_drct.py's GOLDEN) in bf16
  against flax's bf16 (tests/test_torch_span.py's `check_bf16`: the output
  within 2e-2 of its largest, each gradient's L2 distance from the port's
  fp32 one at most twice flax's plus 1e-2 of its norm), the bf16 forms
  uncounted (their plain versions run);
- the 9 templates under configs/_templates/train/DRCT/ resolve their
  options and build network_g (and network_d) in the port in bf16, as
  shipped (on the meta device: no forward is run).
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from tests.test_torch_drct import GOLDEN
from tests.test_torch_span import check_bf16
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

TRAIN = Path(__file__).resolve().parent.parent / "configs" / "_templates" / "train"
TEMPLATES = sorted(p.name for p in (TRAIN / "DRCT").glob("*.yml"))


def test_drct_bf16_matches_flax():
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    counted = (fb.fused_ln_mlp_bf16, fb.fused_ln_mlp_backward_bf16, wa.fused_window_mhsa_bf16,
               wa.fused_window_mhsa_backward_bf16)
    n0 = [f.launches for f in counted]
    check_bf16(GOLDEN, "DRCT", 2)
    # on the CPU the bf16 forms run their plain versions, uncounted
    assert [f.launches for f in counted] == n0


def test_template_count():
    assert len(TEMPLATES) == 9


@pytest.mark.parametrize("template", TEMPLATES)
def test_template_builds_in_the_port(template):
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.options import yaml_load

    opt, _ = yaml_load(str(TRAIN / "DRCT" / template))
    assert opt.compute_dtype == "bfloat16"
    with torch.device("meta"):
        net = build_network_cast({**opt.network_g, "scale": opt.scale}, torch.bfloat16)
    assert type(net).__name__ == "DRCT"
    assert net.compute_dtype == torch.bfloat16 and net.bf16_refusal() is None
    assert sum(p.numel() for p in net.parameters()) > 0
    if opt.network_d is not None:
        net_d = build_network_cast(dict(opt.network_d), torch.bfloat16)
        assert type(net_d).__name__ == "DUnet" and net_d.compute_dtype == torch.bfloat16
