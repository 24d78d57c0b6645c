"""Model selection (parity: the JAX package's models/__init__.py). Only
SRModel is ported; the other models raise."""

from __future__ import annotations

from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.registry import MODEL_REGISTRY

__all__ = ["build_model", "MODEL_REGISTRY"]


def build_model(opt: ReduxOptions, device=None):
    import trainner_redux_tpu_torch.models.sr_model  # noqa: F401

    if opt.high_order_degradation or (opt.network_ae is not None and opt.network_g is None):
        raise NotImplementedError("only SRModel is ported to torch yet")
    return MODEL_REGISTRY.get("SRModel")(opt, device=device)
