"""Optimizers on torch.optim with optax's semantics (port of the JAX
package's optimizers/__init__.py: adam, adamw, build_optimizer).

Config dicts use the torch argument surface (lr, betas, eps,
weight_decay). Where the config leaves a value out, optax's default holds,
not torch's: `optax.adamw` decays by 1e-4 (torch.optim.AdamW by 1e-2), and
Adam drops weight_decay as the JAX package does. The learning rate of step
t is `schedule(t)`, set on the optimizer before the step (`set_lr`);
`grad_clip` clips the global gradient norm to 1.0 before the update.
Other optimizer types raise.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable
from typing import Any

import torch

from trainner_redux_tpu_torch.schedulers import Schedule, build_scheduler, with_warmup

OPTAX_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8}


def _common(opt: dict[str, Any]) -> dict[str, Any]:
    betas = opt.pop("betas", OPTAX_DEFAULTS["betas"])
    if len(betas) != 2:
        raise NotImplementedError(f"betas {betas}: Adam takes two")
    out = {"betas": (float(betas[0]), float(betas[1])),
           "eps": float(opt.pop("eps", OPTAX_DEFAULTS["eps"]))}
    if opt:
        raise NotImplementedError(f"optimizer options {sorted(opt)} are not ported to torch yet")
    return out


def adam(params: Iterable[torch.nn.Parameter], **opt: Any) -> torch.optim.Optimizer:
    opt.pop("weight_decay", None)  # the JAX package drops Adam's L2 term too
    return torch.optim.Adam(params, lr=0.0, weight_decay=0.0, **_common(opt))


def adamw(params: Iterable[torch.nn.Parameter], **opt: Any) -> torch.optim.Optimizer:
    wd = float(opt.pop("weight_decay", 1e-4))  # optax.adamw's default
    return torch.optim.AdamW(params, lr=0.0, weight_decay=wd, **_common(opt))


OPTIMIZERS: dict[str, Callable[..., torch.optim.Optimizer]] = {"adam": adam, "adamw": adamw}


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_opt: dict[str, Any],
                    total_iter: int, scheduler_opt: dict[str, Any] | None = None,
                    warmup_iter: int | None = -1) -> tuple[torch.optim.Optimizer, Schedule]:
    """(torch optimizer, lr schedule) from a reference-style optim dict."""
    opt = dict(optim_opt)
    otype = str(opt.pop("type", "Adam")).lower()
    if otype not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{otype}' is not ported to torch yet (ported: {', '.join(OPTIMIZERS)})"
        )
    base_lr = float(opt.pop("lr", 1e-4))
    schedule = with_warmup(build_scheduler(scheduler_opt, base_lr, total_iter), warmup_iter)
    return OPTIMIZERS[otype](params, **opt), schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], norm: torch.Tensor,
                        max_norm: float = 1.0) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / norm where the
    norm exceeds max_norm."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
