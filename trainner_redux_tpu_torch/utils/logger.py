"""Logging: the root logger, the environment banner, the step timer and
the per-iteration training message.

Same output format as the JAX package's `utils/logger.py`, with the torch,
CUDA and card inventory in the banner and the card's allocated memory in the
training message. `init_tb_logger` opens a TensorBoard writer (torch's
`SummaryWriter`, else tensorboardX's, else none with a warning), imported
only when a run asks for one; `MessageLogger` mirrors its scalars to it
under the JAX package's tags. The wandb logger is not ported.
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


def init_tb_logger(log_dir: str) -> Any:
    """A TensorBoard writer into `log_dir`: torch's SummaryWriter, else
    tensorboardX's, else None with a warning (the JAX package's
    `init_tb_logger`). Imported here, only when a run sets use_tb_logger."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # noqa: BLE001 - tensorboard missing or broken
        try:
            from tensorboardX import SummaryWriter  # type: ignore[no-redef]
        except Exception:  # noqa: BLE001
            get_root_logger().warning("use_tb_logger: neither torch.utils.tensorboard nor "
                                      "tensorboardX imports; no TensorBoard logs")
            return None
    return SummaryWriter(log_dir=log_dir)


def _scalar_tag(k: str) -> str:
    """The TensorBoard tag of a logged value, as the JAX MessageLogger
    groups them."""
    if k.startswith(("grad_norm", "grad_")):
        return f"gradients/{k}"
    if k.startswith("l_"):
        return f"losses/{k}"
    if k.startswith("m_"):
        return f"metrics/{k}"
    if k.startswith(("lw_", "dls_")):
        return f"dynamic_loss_weights/{k}"
    return k


class MessageLogger:
    """Formats the per-iteration training log line:
    ``[name..][epoch, iter, lr] [perf: it/s] [eta] [mem] l_g_l1: ...``, and
    mirrors its scalars to `tb_logger` where given, under the JAX package's
    tags (performance/, gradients/, losses/, metrics/,
    dynamic_loss_weights/, loss_balance/; the card's memory as
    performance/hbm_in_use_gb and hbm_peak_gb)."""

    def __init__(self, opt, tb_logger: Any = None) -> None:
        self.exp_name = opt.name
        self.max_iters = opt.train.total_iter if opt.train else 0
        self.tb_logger = tb_logger
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
        tb = self.tb_logger
        samples_per_sec = log_vars.pop("samples_per_sec", None)
        if time_sec_avg > 0:
            eta_sec = time_sec_avg * (self.max_iters - current_iter)
            message += (f"[perf: {1.0 / time_sec_avg:.3f} it/s] "
                        f"[eta: {datetime.timedelta(seconds=int(eta_sec))}] ")
            if tb:
                tb.add_scalar("performance/throughput_samples_per_sec",
                              samples_per_sec or 1.0 / time_sec_avg, current_iter)
                tb.add_scalar("performance/avg_iter_time_sec", time_sec_avg, current_iter)
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            in_use = torch.cuda.memory_allocated() / 2**30
            peak = torch.cuda.max_memory_allocated() / 2**30
            message += f"[mem: {in_use:.2f}/{peak:.2f}G] "
            if tb:
                tb.add_scalar("performance/hbm_in_use_gb", in_use, current_iter)
                tb.add_scalar("performance/hbm_peak_gb", peak, current_iter)
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if tb:
                tb.add_scalar(_scalar_tag(k), v, current_iter)
        total = log_vars.get("l_g_total")
        if tb and total and abs(total) > 1e-12:  # each weighted term's share of the total
            for k, v in log_vars.items():
                if k.startswith("l_g_") and k != "l_g_total" and isinstance(v, float):
                    tb.add_scalar(f"loss_balance/{k}_ratio", v / total, current_iter)
        self.logger.info(message)
