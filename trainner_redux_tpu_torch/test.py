"""Inference/eval entry point of the torch port (parity: the JAX package's
root `test.py`).

    python -m trainner_redux_tpu_torch.test -opt options/test/x.yml

runs on the CUDA card; `TRAINNER_PLATFORM=cpu` asks for the CPU. Results go
under `<repo>/results/<name>/`. `parse` turns the command line into options
and `run` serves them, so a caller with options of its own (decoded with
`utils.schema.decode` and completed by `utils.options.resolve_options`)
calls `run` directly.
"""

from __future__ import annotations

import logging
import sys
from os import path as osp

from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions

REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def parse(root_path: str = REPO_ROOT, argv: list[str] | None = None) -> ReduxOptions:
    from trainner_redux_tpu_torch.utils.config import Config

    opt, _args = Config.load_config_from_file(root_path, is_train=False, argv=argv)
    return opt


def run(opt: ReduxOptions, device=None):
    """Evaluate every dataset of `opt`; returns the model, whose
    `metric_results` hold the last dataset's averaged metrics."""
    from trainner_redux_tpu_torch.data import build_dataloader, build_dataset
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils import get_env_info, get_root_logger, make_exp_dirs
    from trainner_redux_tpu_torch.utils.device import resolve_device
    from trainner_redux_tpu_torch.utils.options import dict2str

    device = resolve_device(device)
    make_exp_dirs(opt)
    log_file = osp.join(opt.path.log or ".", f"test_{opt.name}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _phase, dataset_opt in sorted(opt.datasets.items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
        logger.info(f"Number of test images in {dataset_opt.name}: {len(test_set)}")

    model = build_model(opt, device=device)
    for test_loader in test_loaders:
        logger.info(f"Testing {test_loader.dataset.opt.name}...")
        model.validation(
            test_loader,
            current_iter=opt.name,
            tb_logger=None,
            save_img=bool(opt.val.save_img if opt.val else True),
        )
    return model


def test_pipeline(root_path: str = REPO_ROOT, argv: list[str] | None = None, device=None):
    return run(parse(root_path, argv), device=device)


if __name__ == "__main__":
    test_pipeline(REPO_ROOT, sys.argv[1:])
