"""CLI + YAML option parsing and experiment path derivation.

Same CLI surface as the reference (upstream traiNNer-redux, `traiNNer/utils/options.py`):
``-opt``, ``--launcher``, ``--auto_resume``, ``--resume``, ``--watch``,
``--start-iter``, ``--debug``, ``--manual_seed``, ``--name``. `num_gpu`
("auto") resolves to the local CUDA device count. `yaml` is imported where it
is used.
"""

from __future__ import annotations

import argparse
import random
from os import path as osp
from typing import Any

from trainner_redux_tpu_torch.utils.dist_util import get_dist_info, init_dist
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.schema import StrictDecodeError, decode, encode_dict


def yaml_load(path: str) -> tuple[ReduxOptions, str]:
    """Strictly decode a YAML config file into a ReduxOptions tree."""
    import yaml

    with open(path, encoding="utf-8") as f:
        contents = f.read()
    raw = yaml.safe_load(contents)
    if not isinstance(raw, dict):
        raise StrictDecodeError(f"config file {path} did not parse to a mapping")
    opt = decode(raw, ReduxOptions)
    return opt, contents


def dict2str(opt: Any, indent_level: int = 1) -> str:
    """Pretty-print an options tree for logging."""
    if not isinstance(opt, dict):
        opt = encode_dict(opt)
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def assert_not_using_template(opt_path: str) -> None:
    """Refuse to train directly on a template config (reference options.py:27-54)."""
    parts = osp.normpath(osp.abspath(opt_path)).split(osp.sep)
    if "_templates" in parts:
        raise ValueError(
            "Template configs must not be used directly. Copy the template into "
            "your own options directory, modify it, and train with the copy."
        )


def parse_options(
    root_path: str, is_train: bool = True, argv: list[str] | None = None
) -> tuple[ReduxOptions, argparse.Namespace]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument(
        "--launcher",
        choices=["none", "pytorch", "slurm"],
        default="none",
        help="job launcher (only 'none' is ported: one process, one card)",
    )
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--resume", type=int, default=0)
    parser.add_argument("--watch", action="store_true")
    parser.add_argument("--start-iter", type=int, default=0)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--manual_seed", type=int, default=None)
    parser.add_argument("--name", type=str, default=None)
    args = parser.parse_args(argv)

    assert_not_using_template(args.opt)
    opt, contents = yaml_load(args.opt)
    opt.contents = contents

    # distributed settings (one process in this port)
    if args.launcher == "none":
        opt.dist = False
    else:
        opt.dist = True
        init_dist(args.launcher, **(opt.dist_params or {}))
    opt.launcher = args.launcher
    opt.rank, opt.world_size = get_dist_info()

    if args.name:
        opt.name = args.name
    if args.debug and not opt.name.startswith("debug"):
        opt.name = "debug_" + opt.name

    if args.manual_seed:
        opt.manual_seed = args.manual_seed
    if not opt.manual_seed:
        opt.manual_seed = random.randint(1024, 10000)

    opt.auto_resume = args.auto_resume
    opt.watch = args.watch
    opt.start_iter = args.start_iter
    resolve_options(opt, root_path, is_train)
    return opt, args


def resolve_options(opt: ReduxOptions, root_path: str, is_train: bool) -> ReduxOptions:
    """Fill in what the CLI derives from a decoded config: the phase and
    scale of each dataset, expanded paths, `num_gpu`, and the experiment or
    results directories under `root_path`. `parse_options` calls it; a caller
    that decodes options itself calls it before handing them on."""
    opt.is_train = is_train
    opt.root_path = root_path

    if opt.num_gpu == "auto":
        import torch

        opt.num_gpu = torch.cuda.device_count()

    # datasets: propagate phase/scale, expand paths
    for full_phase, dataset in opt.datasets.items():
        phase = full_phase.split("_")[0]
        dataset.phase = phase
        dataset.scale = opt.scale
        if dataset.dataroot_gt is not None:
            if isinstance(dataset.dataroot_gt, str):
                dataset.dataroot_gt = [osp.expanduser(dataset.dataroot_gt)]
            else:
                dataset.dataroot_gt = [osp.expanduser(p) for p in dataset.dataroot_gt]
        if dataset.dataroot_lq is not None:
            if isinstance(dataset.dataroot_lq, str):
                dataset.dataroot_lq = [osp.expanduser(dataset.dataroot_lq)]
            else:
                dataset.dataroot_lq = [osp.expanduser(p) for p in dataset.dataroot_lq]

    if opt.path.resume_state is not None:
        opt.path.resume_state = osp.expanduser(opt.path.resume_state)
    if opt.path.pretrain_network_g is not None:
        opt.path.pretrain_network_g = osp.expanduser(opt.path.pretrain_network_g)
    if opt.path.pretrain_network_d is not None:
        opt.path.pretrain_network_d = osp.expanduser(opt.path.pretrain_network_d)

    if is_train:
        experiments_root = osp.join(root_path, "experiments", opt.name)
        opt.path.experiments_root = experiments_root
        opt.path.models = osp.join(experiments_root, "models")
        opt.path.resume_models = osp.join(opt.path.models, "resume_models")
        opt.path.training_states = osp.join(experiments_root, "training_states")
        opt.path.log = experiments_root
        opt.path.visualization = osp.join(experiments_root, "visualization")
    else:
        results_root = osp.join(root_path, "results", opt.name)
        opt.path.results_root = results_root
        opt.path.log = results_root
        opt.path.visualization = osp.join(results_root, "visualization")

    warn_inert_fields(opt)
    return opt


# Config fields accepted for YAML compatibility that have NO consumer in the
# reference either — legacy Real-ESRGAN v1 two-stage keys superseded by the
# 6-stage pipeline (reference realesrgan_model.py implements no classic
# second stage), knobs stored-but-never-read (blur_kernel_size2,
# switch_iter_per_epoch), and the legacy per-codec probs whose fallback path
# is unreachable under the strict schema (paragon_otf_degradations.py:64-69
# requires compression_formats to be ABSENT, which the schema's default
# makes impossible). Accepting them silently would imply they do something;
# instead a non-default value warns once at parse time.
_INERT_FIELDS: dict[str, object] = {
    "auto_vram_management": False,
    "blur_prob2": None, "gaussian_noise_prob2": None, "gray_noise_prob2": None,
    "jpeg_prob": None, "jpeg_prob2": None, "jpeg_range": None, "jpeg_range2": None,
    "noise_range2": None, "poisson_scale_range": None, "poisson_scale_range2": None,
    "resize_prob": None, "resize_prob2": None,
    "resize_range": None, "resize_range2": None,
    "resize_mode_list": None, "resize_mode_list2": None,
    "resize_mode_prob": None, "resize_mode_prob2": None,
    "lq_usm": None, "lq_usm_radius_range": None,
    "predefined_sequences": None, "thicklines_prob": None,
    "switch_iter_per_epoch": None,
    "webp_prob": None, "webp_range": None,
    "avif_prob": None, "avif_range": None,
    "heif_prob": None, "heif_range": None,
}


def warn_inert_fields(opt: ReduxOptions) -> None:
    """Warn (once per parse) about accepted-but-inert config keys set to
    non-default values, so every accepted field is either real or loud."""
    import dataclasses

    defaults = {}
    for f in dataclasses.fields(ReduxOptions):
        if f.default is not dataclasses.MISSING:
            defaults[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            defaults[f.name] = f.default_factory()
    noisy = []
    for name, fallback in _INERT_FIELDS.items():
        default = defaults.get(name, fallback)
        val = getattr(opt, name, None)
        if val is not None and val != default:
            noisy.append(name)
    if noisy:
        print(
            "NOTE: these config fields are accepted for compatibility but are "
            "inert in the reference framework as well (no consumer); they do "
            f"nothing here either: {', '.join(sorted(noisy))}"
        )
