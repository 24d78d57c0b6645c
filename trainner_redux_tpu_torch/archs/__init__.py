"""Architectures of the port: registration + build_network.

Parity: the JAX package's archs/__init__.py, without its directory scan:
only the ported archs (SwinIR) are imported and registered.
"""

from __future__ import annotations

from typing import Any

from trainner_redux_tpu_torch.archs import swinir_arch  # noqa: F401 (registers swinir_*)
from trainner_redux_tpu_torch.utils.registry import ARCH_REGISTRY

__all__ = ["build_network", "ARCH_REGISTRY"]


def build_network(opt: dict[str, Any]):
    """Instantiate a network from an options dict ({'type': ..., **kwargs}).
    The model layer injects `scale`. Returns an nn.Module on the CPU."""
    opt = dict(opt)
    network_type = opt.pop("type")
    factory = ARCH_REGISTRY.get_optional(network_type)
    if factory is None:
        raise KeyError(
            f"Network type '{network_type}' is not ported to torch. "
            f"Known: {ARCH_REGISTRY.keys()}"
        )
    return factory(**opt)
