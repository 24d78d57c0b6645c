"""Misc utilities: seeding, experiment dirs, resume scanning, formatting.

Behavioral parity with the JAX package's utils/misc.py. Seeding covers the
host's global generators (`random`, numpy); the port's own randomness uses
explicit generators (data: `utils.rng.worker_rng`; DropPath: the model's
torch.Generator), so torch's global generator is not seeded.
"""

from __future__ import annotations

import os
import random
import time
from os import path as osp

import numpy as np

from trainner_redux_tpu_torch.utils.dist_util import master_only


def set_random_seed(seed: int) -> None:
    """Seed the host's global generators (`random`, numpy)."""
    random.seed(seed)
    np.random.seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """Make a directory; archive an existing one with a timestamp suffix."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


@master_only
def make_exp_dirs(opt) -> None:
    """Create experiment directory tree (models, states, visualization)."""
    path_opt = opt.path
    if opt.is_train:
        assert path_opt.experiments_root is not None
        if opt.auto_resume or (opt.name or "").startswith("debug"):
            os.makedirs(path_opt.experiments_root, exist_ok=True)
        else:
            mkdir_and_rename(path_opt.experiments_root)
        for sub in (
            path_opt.models,
            path_opt.resume_models,
            path_opt.training_states,
            path_opt.visualization,
        ):
            if sub:
                os.makedirs(sub, exist_ok=True)
    else:
        assert path_opt.results_root is not None
        os.makedirs(path_opt.results_root, exist_ok=True)
        if path_opt.visualization:
            os.makedirs(path_opt.visualization, exist_ok=True)


def scandir(
    dir_path: str,
    suffix: str | tuple[str, ...] | None = None,
    recursive: bool = False,
    full_path: bool = False,
):
    """Yield file paths under `dir_path`, optionally filtered/recursive."""
    root = dir_path

    def _scandir(dir_path: str, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                rel = entry.path if full_path else osp.relpath(entry.path, root)
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix, recursive)

    return _scandir(dir_path, suffix, recursive)


def check_resume(opt, resume_iter: int) -> None:
    """When resuming, point the pretrained-network paths at the
    `resume_models/net_<g|d>_<iter>` checkpoints of that iteration, unless
    the network is listed in `ignore_resume_networks`."""
    if opt.path.resume_state is None or opt.path.resume_models is None:
        return
    ignore = set(opt.path.ignore_resume_networks or [])
    for net_key, attr in (("network_g", "pretrain_network_g"),
                          ("network_d", "pretrain_network_d")):
        if getattr(opt, net_key, None) is None or net_key in ignore:
            continue
        for ext in (".safetensors", ".ckpt", ".pth"):
            candidate = osp.join(opt.path.resume_models, f"net_{net_key[-1]}_{resume_iter}{ext}")
            if osp.exists(candidate):
                setattr(opt.path, attr, candidate)
                break
