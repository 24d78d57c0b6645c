"""Strict typed decoding of YAML/JSON mappings into dataclass trees.

The reference framework uses msgspec Structs with ``forbid_unknown_fields``
(upstream traiNNer-redux, traiNNer/utils/redux_options.py) so that a typo'd config
key is a hard error. msgspec is not a dependency, so this module provides
the same guarantees on top of stdlib dataclasses:

- unknown keys are errors (with the path into the config reported),
- values are type-checked and coerced against the annotation
  (int/float/bool/str, Optional, Literal, list[...], tuple[...], dict[...],
  nested dataclasses),
- missing required fields are errors.

`encode_dict` turns a decoded tree back into plain values for logging.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any, Literal, Union

__all__ = ["StrictDecodeError", "decode", "encode_dict"]


class StrictDecodeError(ValueError):
    """Raised when a config mapping does not match the schema."""


def _type_name(tp: Any) -> str:
    try:
        return tp.__name__
    except AttributeError:
        return str(tp)


def _decode_value(value: Any, tp: Any, path: str) -> Any:
    """Decode `value` against annotation `tp`, raising StrictDecodeError on mismatch."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)

    # Any: pass through
    if tp is Any or tp is dataclasses.MISSING:
        return value

    # Union / Optional
    if origin is Union or origin is types.UnionType:
        errors = []
        # try None first for Optional, then non-None members
        for member in args:
            if member is type(None):
                if value is None:
                    return None
                continue
        for member in args:
            if member is type(None):
                continue
            try:
                return _decode_value(value, member, path)
            except StrictDecodeError as e:
                errors.append(str(e))
        raise StrictDecodeError(
            f"{path}: value {value!r} does not match any of "
            f"{[_type_name(a) for a in args]}"
        )

    # Literal
    if origin is Literal:
        if value in args:
            return value
        raise StrictDecodeError(f"{path}: value {value!r} not one of {list(args)}")

    # Nested dataclass
    if dataclasses.is_dataclass(tp) and isinstance(tp, type):
        if not isinstance(value, dict):
            raise StrictDecodeError(
                f"{path}: expected mapping for {_type_name(tp)}, got {type(value).__name__}"
            )
        return decode(value, tp, path=path)

    # Containers
    if origin in (list, typing.List):  # noqa: UP006
        if not isinstance(value, (list, tuple)):
            raise StrictDecodeError(f"{path}: expected list, got {type(value).__name__}")
        elem_tp = args[0] if args else Any
        return [_decode_value(v, elem_tp, f"{path}[{i}]") for i, v in enumerate(value)]

    if origin in (tuple, typing.Tuple):  # noqa: UP006
        if not isinstance(value, (list, tuple)):
            raise StrictDecodeError(f"{path}: expected sequence, got {type(value).__name__}")
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(
                _decode_value(v, args[0], f"{path}[{i}]") for i, v in enumerate(value)
            )
        if args:
            if len(value) != len(args):
                raise StrictDecodeError(
                    f"{path}: expected {len(args)} elements, got {len(value)}"
                )
            return tuple(
                _decode_value(v, t, f"{path}[{i}]")
                for i, (v, t) in enumerate(zip(value, args, strict=True))
            )
        return tuple(value)

    if origin in (dict, typing.Dict):  # noqa: UP006
        if not isinstance(value, dict):
            raise StrictDecodeError(f"{path}: expected mapping, got {type(value).__name__}")
        if args:
            key_tp, val_tp = args
            return {
                _decode_value(k, key_tp, f"{path}.<key>"): _decode_value(
                    v, val_tp, f"{path}.{k}"
                )
                for k, v in value.items()
            }
        return dict(value)

    # Scalars (with YAML-friendly coercions)
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise StrictDecodeError(f"{path}: expected bool, got {value!r}")
    if tp is int:
        if isinstance(value, bool):
            raise StrictDecodeError(f"{path}: expected int, got bool {value!r}")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise StrictDecodeError(f"{path}: expected int, got {value!r}")
    if tp is float:
        if isinstance(value, bool):
            raise StrictDecodeError(f"{path}: expected float, got bool {value!r}")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            # YAML 1.1 parses "1e-4" as str in some emitters; accept numeric strings
            try:
                return float(value)
            except ValueError:
                pass
        raise StrictDecodeError(f"{path}: expected float, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise StrictDecodeError(f"{path}: expected str, got {value!r}")

    # Fallback: isinstance check
    if isinstance(tp, type):
        if isinstance(value, tp):
            return value
        raise StrictDecodeError(
            f"{path}: expected {_type_name(tp)}, got {type(value).__name__}"
        )
    return value


def decode(data: dict[str, Any], cls: type, path: str = "<root>") -> Any:
    """Decode a mapping into dataclass `cls`, strictly (unknown keys are errors)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"decode target must be a dataclass, got {cls!r}")
    if not isinstance(data, dict):
        raise StrictDecodeError(
            f"{path}: expected mapping for {_type_name(cls)}, got {type(data).__name__}"
        )

    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}

    unknown = set(data) - set(fields)
    if unknown:
        raise StrictDecodeError(
            f"{path}: unknown field(s) {sorted(unknown)} for {_type_name(cls)}. "
            f"Known fields: {sorted(fields)}"
        )

    kwargs: dict[str, Any] = {}
    for name, f in fields.items():
        if name in data:
            kwargs[name] = _decode_value(data[name], hints.get(name, Any), f"{path}.{name}")
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
        ):
            raise StrictDecodeError(
                f"{path}: missing required field '{name}' for {_type_name(cls)}"
            )
    return cls(**kwargs)


def encode_dict(obj: Any) -> Any:
    """Recursively convert a dataclass tree back into plain dict/list values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: encode_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: encode_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_dict(v) for v in obj]
    return obj
