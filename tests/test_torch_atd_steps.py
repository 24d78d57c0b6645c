"""ATD's training steps against the JAX package, on the CPU, and the 12
SRFormer and ATD training templates.

- three L1 `SRModel` steps (AdamW, EMA) of an atd_light-shaped tiny net
  (tests/test_torch_atd.py's LIGHT: embed 24, one group of two layers, 3
  heads of 8, ws 16, category_size 48 on 256 tokens) against the JAX
  `SRModel` within 1e-5 (tests/test_torch_srformer.py's
  `three_steps_match_jax`);
- the 12 templates under configs/_templates/train/{SRFormer,ATD}/ resolve
  their options and build network_g (and network_d) in the port in bf16,
  as shipped; no forward is run (the arithmetic is held to the JAX
  package's by tests/test_torch_srformer.py and tests/test_torch_atd.py).
"""

from pathlib import Path

import pytest
import torch

from tests.test_torch_atd import LIGHT
from tests.test_torch_srformer import three_steps_match_jax
from tests.test_torch_train import dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

TRAIN = Path(__file__).resolve().parent.parent / "configs" / "_templates" / "train"


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    three_steps_match_jax(LIGHT, "ATD", dataset, tmp_path, monkeypatch)


TEMPLATES = sorted(str(p.relative_to(TRAIN)) for f in ("SRFormer", "ATD")
                   for p in (TRAIN / f).glob("*.yml"))


def test_template_count():
    assert len(TEMPLATES) == 12


@pytest.mark.parametrize("template", TEMPLATES)
def test_template_builds_in_the_port(template):
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.options import yaml_load

    opt, _ = yaml_load(str(TRAIN / template))
    assert opt.compute_dtype == "bfloat16"
    net = build_network_cast({**opt.network_g, "scale": opt.scale}, torch.bfloat16)
    assert type(net).__name__ in ("SRFormer", "ATD")
    assert net.compute_dtype == torch.bfloat16 and net.bf16_refusal() is None
    assert sum(p.numel() for p in net.parameters()) > 0
    if opt.network_d is not None:
        net_d = build_network_cast(dict(opt.network_d), torch.bfloat16)
        assert type(net_d).__name__ == "DUnet" and net_d.compute_dtype == torch.bfloat16


