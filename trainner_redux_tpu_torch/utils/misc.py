"""Misc utilities: seeding, experiment dirs, resume scanning, formatting.

Behavioral parity with the JAX package's utils/misc.py; seeding also seeds
torch's global generator.
"""

from __future__ import annotations

import os
import time
from os import path as osp

from trainner_redux_tpu_torch.utils.dist_util import master_only


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
