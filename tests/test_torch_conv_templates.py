"""The 48 training templates of the conv families the port now has
(configs/_templates/train/{SPAN,SPANF,SPANPlus,SpanC,Compact,ESRGAN}/): each
resolves its options as shipped and builds its network_g, and its
network_d where it names one (DUnet), in the port at its shipped compute
dtype (bf16 in all 48), with no bf16 refusal. No forward is run: the
networks' arithmetic is held to the JAX package's by
tests/test_torch_span.py, test_torch_spanplus.py, test_torch_spanc.py and
test_torch_compact_esrgan.py. And a fault the OTF templates of batch 16
share in both packages: their queue_size.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

TRAIN = Path(__file__).resolve().parent.parent / "configs" / "_templates" / "train"
FAMILIES = ("SPAN", "SPANF", "SPANPlus", "SpanC", "Compact", "ESRGAN")
TEMPLATES = sorted(str(p.relative_to(TRAIN)) for f in FAMILIES for p in (TRAIN / f).glob("*.yml"))


def test_template_count():
    assert len(TEMPLATES) == 48


@pytest.mark.parametrize("template", TEMPLATES)
def test_template_builds_in_the_port(template):
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.utils.options import yaml_load

    opt, _ = yaml_load(str(TRAIN / template))
    assert opt.compute_dtype == "bfloat16"
    net = build_network_cast({**opt.network_g, "scale": opt.scale}, torch.bfloat16)
    assert net.compute_dtype == torch.bfloat16 and net.bf16_refusal() is None
    assert sum(p.numel() for p in net.parameters()) > 0
    if opt.network_d is not None:
        net_d = build_network_cast(dict(opt.network_d), torch.bfloat16)
        assert type(net_d).__name__ == "DUnet" and net_d.compute_dtype == torch.bfloat16


def test_batch_16_otf_templates_refuse_their_queue_size_in_both_packages():
    """A fault of the JAX package's templates (ROADMAP.md section 3): 24
    `*_otf.yml` templates set batch 16 and leave queue_size at its default
    120, which is no multiple of 16, so the pair pool refuses their first
    batch in both packages (the JAX RealESRGANModel.feed_data's check and
    the port's `_through_pool`, each run on the template's numbers). The
    card's compact_otf run sets queue_size to twice the batch, as bench.py's
    OTF workloads do."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from trainner_redux_tpu.models.realesrgan_model import RealESRGANModel as JaxOTF
    from trainner_redux_tpu_torch.models.realesrgan_model import RealESRGANModel
    from trainner_redux_tpu_torch.utils.options import yaml_load

    bad = []
    for path in sorted(TRAIN.glob("*/*_otf.yml")):
        opt, _ = yaml_load(str(path))
        batch = opt.datasets["train"].batch_size_per_gpu
        if opt.queue_size % batch:
            bad.append((path.name, batch, opt.queue_size))
    assert len(bad) == 24 and ("compact_otf.yml", 16, 120) in bad
    gt = np.zeros((16, 32, 32, 3), np.float32)
    jstub = SimpleNamespace(
        is_train=True, shard_batch=lambda d: d, _feed_count=0, sequence_controller=None,
        opt=SimpleNamespace(manual_seed=0), queue_size=120, _pool=None,
        _degrade_jit=lambda g, *a, **k: (jnp.asarray(g), jnp.asarray(g[:, ::4, ::4])))
    data = {"gt": gt, "kernel1": gt, "kernel2": gt, "sinc_kernel": gt}
    with pytest.raises(ValueError, match="queue_size 120 must be a multiple of batch 16"):
        JaxOTF.feed_data(jstub, data)
    stub = SimpleNamespace(queue_size=120, _pool=None)
    with pytest.raises(ValueError, match="queue_size 120 must be a multiple of batch 16"):
        RealESRGANModel._through_pool(stub, torch.zeros(16, 3, 32, 32), torch.zeros(16, 3, 8, 8))
