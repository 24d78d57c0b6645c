"""Architectures of the port: registration + build_network.

Parity: the JAX package's archs/__init__.py, without its directory scan:
only the ported archs (SwinIR, HAT, DAT, Swin2SR, SRFormerV2) are imported and registered, and
`build_network` resolves a type in SPANDREL_REGISTRY, then ARCH_REGISTRY,
as the JAX package does.
"""

from __future__ import annotations

from typing import Any

from trainner_redux_tpu_torch.archs import dat_arch  # noqa: F401 (registers dat*)
from trainner_redux_tpu_torch.archs import hat_arch  # noqa: F401 (registers hat*)
from trainner_redux_tpu_torch.archs import srformerv2_arch  # noqa: F401 (registers srformerv2)
from trainner_redux_tpu_torch.archs import swin2sr_arch  # noqa: F401 (registers swin2sr_*)
from trainner_redux_tpu_torch.archs import swinir_arch  # noqa: F401 (registers swinir_*)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY, SPANDREL_REGISTRY

__all__ = ["build_network", "ARCH_REGISTRY", "SPANDREL_REGISTRY"]


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
