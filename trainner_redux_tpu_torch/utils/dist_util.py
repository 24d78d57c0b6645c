"""Distributed helpers for one process.

The port serves on one card in one process. `torch.distributed` is read
when a caller has initialised it; the CLI's multi-process launchers are not
ported yet and refuse to start.
"""

from __future__ import annotations

import functools
from collections.abc import Callable
from typing import Any


def init_dist(launcher: str = "none", **kwargs: Any) -> None:
    """Accept the single-process launcher; refuse the others."""
    if launcher != "none":
        raise NotImplementedError(
            f"launcher '{launcher}': multi-process runs are not ported to torch yet"
        )


def get_dist_info() -> tuple[int, int]:
    """Return (rank, world_size); (0, 1) unless torch.distributed is live."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_rank() -> int:
    return get_dist_info()[0]


def is_master() -> bool:
    return get_rank() == 0


def master_only(func: Callable) -> Callable:
    """Run the wrapped function only on rank 0 (checkpointing, logging, ...)."""

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        if is_master():
            return func(*args, **kwargs)
        return None

    return wrapper
