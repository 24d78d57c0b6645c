"""Process-global config access (parity: the JAX package's utils/config.py)."""

from __future__ import annotations

import argparse

from trainner_redux_tpu_torch.utils.options import parse_options
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions


class Config:
    _config: ReduxOptions | None = None
    _args: argparse.Namespace | None = None

    @classmethod
    def load_config_from_file(
        cls, root_path: str, is_train: bool = True, argv: list[str] | None = None
    ) -> tuple[ReduxOptions, argparse.Namespace]:
        opt, args = parse_options(root_path, is_train=is_train, argv=argv)
        cls._config = opt
        cls._args = args
        return opt, args

    @classmethod
    def set_config(cls, opt: ReduxOptions) -> None:
        cls._config = opt

    @classmethod
    def get_config(cls) -> ReduxOptions:
        if cls._config is None:
            raise RuntimeError("Config accessed before it was loaded")
        return cls._config

    @classmethod
    def get_scale(cls) -> int:
        return cls.get_config().scale

    @classmethod
    def get_manual_seed(cls) -> int | None:
        return cls.get_config().manual_seed

    @classmethod
    def reset(cls) -> None:
        cls._config = None
        cls._args = None
