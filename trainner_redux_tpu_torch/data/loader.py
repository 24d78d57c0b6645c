"""The evaluation loader: batch 1, in dataset order.

Parity: the val/test branch of the JAX package's `build_dataloader`
(data/__init__.py), which yields batches collated by `default_collate`.
Here it is `torch.utils.data.DataLoader` with that collate, so every batch
holds numpy arrays of shape (1, H, W, C) and the sample's paths as strings.
The threaded training loader comes with the training data path.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def default_collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack ndarray fields into batches; non-arrays become lists."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals if len(vals) > 1 else vals[0]
    return out


def eval_loader(dataset, num_workers: int = 0):
    """Batch-1, in-order loader over a map-style dataset."""
    from torch.utils.data import DataLoader

    return DataLoader(
        dataset,
        batch_size=1,
        shuffle=False,
        num_workers=num_workers,
        collate_fn=default_collate,
    )
