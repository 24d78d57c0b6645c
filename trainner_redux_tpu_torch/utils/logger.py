"""Logging: the root logger and the environment banner.

Same output format as the JAX package's `utils/logger.py`, with the torch,
CUDA and card inventory in the banner.
"""

from __future__ import annotations

import logging
import sys

initialized_loggers: set[str] = set()


def get_root_logger(
    logger_name: str = "trainner_redux_tpu_torch",
    log_level: int = logging.INFO,
    log_file: str | None = None,
) -> logging.Logger:
    logger = logging.getLogger(logger_name)
    if logger_name in initialized_loggers:
        return logger

    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    logger.propagate = False

    from trainner_redux_tpu_torch.utils.dist_util import is_master

    if not is_master():
        logger.setLevel(logging.ERROR)
    else:
        logger.setLevel(log_level)
        if log_file is not None:
            fh = logging.FileHandler(log_file, "a")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    initialized_loggers.add(logger_name)
    return logger


def get_env_info() -> str:
    """Environment banner: versions and the CUDA device inventory."""
    import torch

    lines = [
        "\nEnvironment:",
        f"\tPython: {sys.version.split()[0]}",
        f"\tPyTorch: {torch.__version__}  CUDA: {torch.version.cuda}",
    ]
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        lines.append(f"\tDevices: {names}")
    else:
        lines.append("\tDevices: none (CPU)")
    return "\n".join(lines)
