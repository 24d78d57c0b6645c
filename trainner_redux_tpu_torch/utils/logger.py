"""Logging: the root logger, the environment banner, the step timer and
the per-iteration training message.

Same output format as the JAX package's `utils/logger.py`, with the torch,
CUDA and card inventory in the banner and the card's allocated memory in the
training message. The tensorboard and wandb loggers are not ported yet.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time
from typing import Any

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


class AvgTimer:
    """Sliding-window average of the time between `tic` and `record`
    (window 200, as the reference)."""

    def __init__(self, window: int = 200) -> None:
        self.window = window
        self.times: list[float] = []
        self.tic()

    def tic(self) -> None:
        self.start_time = time.time()

    def record(self) -> None:
        self.times.append(time.time() - self.start_time)
        if len(self.times) > self.window:
            del self.times[: len(self.times) - self.window]
        self.tic()

    def get_avg_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


class MessageLogger:
    """Formats the per-iteration training log line:
    ``[name..][epoch, iter, lr] [perf: it/s] [eta] [mem] l_g_l1: ...``."""

    def __init__(self, opt) -> None:
        self.exp_name = opt.name
        self.max_iters = opt.train.total_iter if opt.train else 0
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict[str, Any]) -> None:
        epoch = log_vars.pop("epoch")
        current_iter = log_vars.pop("iter")
        lrs = log_vars.pop("lrs")
        time_sec_avg = log_vars.pop("time_sec_avg", 0.0)
        message = (
            f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, "
            f"lr:({', '.join(f'{v:.3e}' for v in lrs)})] "
        )
        if time_sec_avg > 0:
            eta_sec = time_sec_avg * (self.max_iters - current_iter)
            message += (f"[perf: {1.0 / time_sec_avg:.3f} it/s] "
                        f"[eta: {datetime.timedelta(seconds=int(eta_sec))}] ")
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            message += (f"[mem: {torch.cuda.memory_allocated() / 2**30:.2f}/"
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}G] ")
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
        self.logger.info(message)
