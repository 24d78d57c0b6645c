"""Architectures of the port: registration + build_network.

Parity: the JAX package's archs/__init__.py, without its directory scan:
only the ported archs (the transformers SwinIR, HAT, DAT, Swin2SR,
SRFormerV2, SRFormer and ATD; the conv families SPAN, SPANF, SPANPlus, SpanC, Compact
(SRVGGNetCompact) and ESRGAN (RRDBNet); the DUnet discriminator) are
imported and registered, and
`build_network` resolves a type in SPANDREL_REGISTRY, then ARCH_REGISTRY,
as the JAX package does.
"""

from __future__ import annotations

from typing import Any

from trainner_redux_tpu_torch.archs import atd_arch  # noqa: F401 (registers atd*)
from trainner_redux_tpu_torch.archs import dat_arch  # noqa: F401 (registers dat*)
from trainner_redux_tpu_torch.archs import dunet_arch  # noqa: F401 (registers dunet)
from trainner_redux_tpu_torch.archs import hat_arch  # noqa: F401 (registers hat*)
from trainner_redux_tpu_torch.archs import rrdbnet_arch  # noqa: F401 (registers esrgan*)
from trainner_redux_tpu_torch.archs import span_arch  # noqa: F401 (registers span*)
from trainner_redux_tpu_torch.archs import spanf_arch  # noqa: F401 (registers spanf)
from trainner_redux_tpu_torch.archs import spanplus_arch  # noqa: F401 (registers spanplus*)
from trainner_redux_tpu_torch.archs import spanpp_arch  # noqa: F401 (registers spanc, spanpp)
from trainner_redux_tpu_torch.archs import srformer_arch  # noqa: F401 (registers srformer*)
from trainner_redux_tpu_torch.archs import srformerv2_arch  # noqa: F401 (registers srformerv2)
from trainner_redux_tpu_torch.archs import srvgg_arch  # noqa: F401 (registers *compact)
from trainner_redux_tpu_torch.archs import swin2sr_arch  # noqa: F401 (registers swin2sr_*)
from trainner_redux_tpu_torch.archs import swinir_arch  # noqa: F401 (registers swinir_*)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY, SPANDREL_REGISTRY

__all__ = ["build_network", "build_network_cast", "ARCH_REGISTRY", "SPANDREL_REGISTRY"]


def build_network(opt: dict[str, Any]):
    """Instantiate a network from an options dict ({'type': ..., **kwargs}).
    The model layer injects `scale`. Returns an nn.Module on the CPU."""
    opt = dict(opt)
    network_type = opt.pop("type")
    factory = SPANDREL_REGISTRY.get_optional(network_type) or ARCH_REGISTRY.get_optional(
        network_type)
    if factory is None:
        raise KeyError(
            f"Network type '{network_type}' is not ported to torch. "
            f"Known: {sorted(set(SPANDREL_REGISTRY.keys()) | set(ARCH_REGISTRY.keys()))}"
        )
    return factory(**opt)


def build_network_cast(opt: dict[str, Any], dtype):
    """build_network with the model's compute dtype (torch.bfloat16 or
    torch.float32) passed as `dtype`, as the JAX package's
    `build_network_cast` passes it to every flax arch (parameters stay
    fp32); an options dict that names its own dtype keeps it. SwinIR, HAT,
    DAT, SRFormerV2, Swin2SR, SRFormer, ATD and the conv families (SPAN, SPANF, SPANPlus,
    SpanC, Compact, ESRGAN) take it as their training compute dtype, DUnet
    as its own."""
    return build_network({"dtype": dtype, **opt})
