"""Host data loaders and the device prefetcher.

Parity: the JAX package's data/loader.py and the val/test branch of its
`build_dataloader`.

- `DataLoader` (training): a pool of worker threads assembles whole batches
  (cv2 decode and numpy copies release the GIL) and a producer thread keeps
  a queue of ready batches, in the order of the sampler's indices, so the
  batches do not depend on thread scheduling.
- `DevicePrefetcher`: `next()` returns a batch whose host-to-device copy
  was issued one call earlier, from pinned host memory with a non-blocking
  copy on the card.
- `eval_loader`: batch 1, in dataset order (`torch.utils.data.DataLoader`).

Every batch holds numpy arrays (N, H, W, C) and the samples' paths.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch


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
    from torch.utils.data import DataLoader as TorchDataLoader

    return TorchDataLoader(
        dataset,
        batch_size=1,
        shuffle=False,
        num_workers=num_workers,
        collate_fn=default_collate,
    )


class DataLoader:
    """Map-style dataset -> iterator of collated batches, assembled by
    `num_workers` threads, at most `prefetch_batches` ready ahead."""

    def __init__(self, dataset, batch_size: int = 1, sampler: Iterable[int] | None = None,
                 shuffle: bool = False, num_workers: int = 4, drop_last: bool = False,
                 prefetch_batches: int = 2, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self) -> list[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, Any]]:
        indices = self._indices()
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            return iter([])

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def assemble(idxs):
            return default_collate([self.dataset[i] for i in idxs])

        def put(item) -> bool:
            """Queue `item` unless the consumer has gone; False once it has."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            window = max(self.prefetch_batches + 2, self.num_workers)
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending: deque = deque()
                try:
                    bi = 0
                    while bi < len(batches) or pending:
                        while bi < len(batches) and len(pending) < window:
                            pending.append(pool.submit(assemble, batches[bi]))
                            bi += 1
                        if not put(pending.popleft().result()):
                            break
                except Exception as e:  # handed to the consumer, which raises it
                    put(e)
                finally:
                    for f in pending:
                        f.cancel()
                    put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                thread.join(timeout=60)

        return gen()


class DevicePrefetcher:
    """One batch ahead: `next()` returns the batch staged by the previous
    call and issues the host-to-device copy of the one after it, so the
    copy is queued before the caller launches the current step. On the card
    the arrays go through pinned host memory with non-blocking copies.
    Returns None once per epoch, when the loader is exhausted."""

    def __init__(self, loader: DataLoader, device: torch.device) -> None:
        self.loader = loader
        self.device = torch.device(device)
        self._iter: Iterator | None = None
        self._staged: Any | None = None

    def reset(self) -> None:
        self._iter = iter(self.loader)
        self._staged = self._fetch()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fetch(self) -> Any:
        if self._iter is None:
            return None
        try:
            batch = next(self._iter)
        except StopIteration:
            self._iter = None
            return None
        return {k: self._put(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}

    def next(self) -> Any:
        ret = self._staged
        self._staged = self._fetch()
        return ret

    def close(self) -> None:
        """Stop the loader's threads of an epoch left unfinished."""
        close = getattr(self._iter, "close", None)
        if close is not None:
            close()
        self._iter = self._staged = None
