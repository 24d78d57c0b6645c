"""Where the port runs.

Entry points run on CUDA unless the caller asks for the CPU: `device="cpu"`
in code, or `TRAINNER_PLATFORM=cpu` for the CLI (the same switch the JAX
package's `test.py` reads). With no card and no such request they raise:
nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on (see the module docstring)."""
    if device is None:
        platform = os.environ.get("TRAINNER_PLATFORM", "").strip().lower()
        device = "cpu" if platform == "cpu" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set "
            "TRAINNER_PLATFORM=cpu to run on the CPU"
        )
    return device
