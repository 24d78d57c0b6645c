"""Model selection (parity: the JAX package's models/__init__.py):
high_order_degradation -> RealESRGANModel (RealESRGANPairedModel when
dataroot_lq_prob > 0), else SRModel. The autoencoder model (network_ae
without network_g) is not ported and raises."""

from __future__ import annotations

from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.registry import MODEL_REGISTRY

__all__ = ["build_model", "MODEL_REGISTRY"]


def build_model(opt: ReduxOptions, device=None):
    import trainner_redux_tpu_torch.models.sr_model  # noqa: F401

    if opt.network_ae is not None and opt.network_g is None:
        raise NotImplementedError("the autoencoder model (network_ae) is not ported to torch yet")
    if opt.high_order_degradation:
        import trainner_redux_tpu_torch.models.realesrgan_model  # noqa: F401

        name = "RealESRGANPairedModel" if opt.dataroot_lq_prob > 0 else "RealESRGANModel"
        return MODEL_REGISTRY.get(name)(opt, device=device)
    return MODEL_REGISTRY.get("SRModel")(opt, device=device)
