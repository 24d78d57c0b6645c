"""Name -> callable registries for every pluggable component family.

Copy of the JAX package's registry: each component family (datasets, archs,
models, metrics) has a global registry that maps a case-insensitive name to
the class or factory registered under it.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any


class Registry:
    """A string -> callable mapping supporting decorator-style registration.

    Usage::

        ARCH_REGISTRY = Registry("arch")

        @ARCH_REGISTRY.register()
        class SPAN(nn.Module): ...

        ARCH_REGISTRY.get("span")  # case-insensitive lookup
    """

    def __init__(self, name: str) -> None:
        self._name = name
        self._obj_map: dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any, *, allow_override: bool = False) -> None:
        key = name.lower()
        if key in self._obj_map and not allow_override:
            raise KeyError(
                f"An object named '{name}' was already registered in '{self._name}' registry!"
            )
        self._obj_map[key] = obj

    def register(
        self, obj: Any = None, *, name: str | None = None, allow_override: bool = False
    ) -> Any:
        """Register `obj` (or use as a decorator when called with no object)."""
        if obj is None:

            def deco(func_or_class: Any) -> Any:
                reg_name = name if name is not None else func_or_class.__name__
                self._do_register(reg_name, func_or_class, allow_override=allow_override)
                return func_or_class

            return deco

        reg_name = name if name is not None else obj.__name__
        self._do_register(reg_name, obj, allow_override=allow_override)
        return obj

    def get(self, name: str) -> Any:
        """Case-insensitive lookup. Raises KeyError with suggestions if missing."""
        key = name.lower()
        obj = self._obj_map.get(key)
        if obj is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map)}"
            )
        return obj

    def get_optional(self, name: str) -> Any | None:
        return self._obj_map.get(name.lower())

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._obj_map

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        return iter(sorted(self._obj_map.items()))

    def keys(self) -> list[str]:
        return sorted(self._obj_map)

    def __len__(self) -> int:
        return len(self._obj_map)

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._obj_map)})"


# The component families of the port. Every ported arch's state dict uses
# the official torch key names; each arch registers where the JAX package
# registers it (SwinIR and HAT in ARCH_REGISTRY, DAT and Swin2SR in SPANDREL_REGISTRY).
DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
SPANDREL_REGISTRY = Registry("spandrel")
MODEL_REGISTRY = Registry("model")
METRIC_REGISTRY = Registry("metric")
LOSS_REGISTRY = Registry("loss")
