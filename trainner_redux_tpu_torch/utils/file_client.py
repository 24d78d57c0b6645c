"""Byte-storage backends (parity: the JAX package's utils/file_client.py).

Only the disk backend is ported; the pack and lmdb backends belong to the
training data path and come with it.
"""

from __future__ import annotations

from typing import Any


class DiskBackend:
    def get(self, filepath: str, client_key: str | None = None) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class FileClient:
    """Dispatches reads to the configured backend."""

    _backends = {"disk": DiskBackend}

    def __init__(self, backend: str = "disk", **kwargs: Any) -> None:
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} not supported by the torch port yet. "
                f"Supported: {sorted(self._backends)}"
            )
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        return self.client.get(filepath)
