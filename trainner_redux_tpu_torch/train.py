"""Training entry point of the torch port (parity: the JAX package's root
`train.py`).

    python -m trainner_redux_tpu_torch.train -opt options/train/x.yml

runs on the CUDA card; `TRAINNER_PLATFORM=cpu` asks for the CPU. The
experiment goes under `<repo>/experiments/<name>/`: models, training states
(`--auto_resume` continues from the newest), the log and the copied config.
`parse` turns the command line into options and `run` trains them, so a
caller with options of its own (decoded with `utils.schema.decode` and
completed by `utils.options.resolve_options`) calls `run` directly.

The loop: a threaded host loader (uint8 crops) and a device prefetcher one
batch ahead, or with a train dataset's `device_cache: true` the images on
the card and each batch cut there (data/device_cache.py); one optimizer
step per batch (`accum_iter` micro-batches
inside it), log lines every `print_freq`, checkpoints every
`save_checkpoint_freq` and at the end, validation every `val_freq` and at
the end, a save on SIGINT or a crash. With `train.bn_recalibrate_batches`,
the BatchNorm statistics are recalibrated before the final save. GAN
training logs D's learning rate beside G's and D's losses and outputs
beside G's, saves `net_d_<iter>` under `models/resume_models/`, and resumes
D, its optimizer and the adaptive-D state from the training state.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
from os import path as osp

from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions

REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def load_resume_state(opt: ReduxOptions) -> str | None:
    """With auto_resume, the newest `training_states/<iter>.state`;
    otherwise `path.resume_state`."""
    if opt.auto_resume:
        state_dir = opt.path.training_states
        if state_dir and osp.isdir(state_dir):
            iters = [int(f.split(".state")[0]) for f in os.listdir(state_dir)
                     if f.endswith(".state.meta.json")]
            if iters:
                opt.path.resume_state = osp.join(state_dir, f"{max(iters)}.state")
                return opt.path.resume_state
        return None
    return opt.path.resume_state


def torch_only_notes(opt: ReduxOptions) -> list[str]:
    """One NOTE line for each torch knob of the config that the port does
    not act on, as the JAX entry prints them (the conditions are its own)."""
    notes = []
    if opt.use_compile or opt.compile_mode:
        notes.append("NOTE: use_compile/compile_mode are torch.compile knobs; the port runs "
                     "eagerly, its hot paths on hand-written CUDA kernels, and compiles nothing.")
    if opt.use_channels_last:
        notes.append("NOTE: use_channels_last is a torch memory-format knob; the port keeps "
                     "the JAX package's layouts (NHWC tokens, NCHW convolutions) and does not "
                     "act on it.")
    if opt.find_unused_parameters:
        notes.append("NOTE: find_unused_parameters is a DDP knob; the port trains on one card "
                     "without DDP and does not act on it.")
    return notes


def create_train_val_dataloaders(opt: ReduxOptions, logger):
    """(train_loader, val_loaders, total_iters)."""
    from trainner_redux_tpu_torch.data import (
        EnlargedSampler,
        build_dataloader,
        build_dataset,
        resolve_enlarge_ratio,
    )

    train_loader, val_loaders, total_iters = None, [], 0
    for phase, dataset_opt in opt.datasets.items():
        if phase.split("_")[0] == "train":
            dataset = build_dataset(dataset_opt, seed=opt.manual_seed or 0)
            ratio = resolve_enlarge_ratio(dataset_opt.dataset_enlarge_ratio, len(dataset))
            sampler = EnlargedSampler(len(dataset), opt.world_size or 1, opt.rank or 0, ratio)
            train_loader = build_dataloader(dataset, dataset_opt, num_gpu=opt.num_gpu,
                                            sampler=sampler, seed=opt.manual_seed)
            # one optimizer step takes accum_iter micro-batches
            train_loader.batch_size *= dataset_opt.accum_iter or 1
            total_iters = int(opt.train.total_iter)
            logger.info(
                f"Training stats: {len(dataset)} images, enlarge ratio {ratio}, "
                f"batch {train_loader.batch_size} (accum {dataset_opt.accum_iter}), "
                f"{max(1, len(train_loader))} iters/epoch, total {total_iters} iters."
            )
        elif phase.split("_")[0] in ("val", "test"):
            dataset = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(dataset, dataset_opt))
            logger.info(f"Validation set {dataset_opt.name}: {len(dataset)} images.")
    if train_loader is None:
        raise ValueError("training requires a train dataset")
    return train_loader, val_loaders, total_iters


def parse(root_path: str = REPO_ROOT, argv: list[str] | None = None):
    from trainner_redux_tpu_torch.utils.config import Config

    return Config.load_config_from_file(root_path, is_train=True, argv=argv)


def run(opt: ReduxOptions, device=None, opt_file: str | None = None):
    """Train `opt` to `train.total_iter`; returns the model. `opt_file`, the
    config's path, is copied into the experiment directory."""
    from trainner_redux_tpu_torch.data import DevicePrefetcher
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils import (
        AvgTimer,
        MessageLogger,
        get_env_info,
        get_root_logger,
        make_exp_dirs,
        set_random_seed,
    )
    from trainner_redux_tpu_torch.utils.device import resolve_device
    from trainner_redux_tpu_torch.utils.options import copy_opt_file, dict2str

    device = resolve_device(device)
    set_random_seed((opt.manual_seed or 0) + (opt.rank or 0))
    resume_state_path = load_resume_state(opt)
    make_exp_dirs(opt)
    if opt_file:
        copy_opt_file(opt_file, opt.path.experiments_root)
    logger = get_root_logger(log_level=logging.INFO,
                             log_file=osp.join(opt.path.log or ".", f"train_{opt.name}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    if opt.logger and (opt.logger.use_tb_logger or opt.logger.wandb):
        logger.warning("tensorboard and wandb logging are not ported to torch yet; "
                       "training logs to the console and the log file only")
    for note in torch_only_notes(opt):
        print(note, flush=True)

    train_loader, val_loaders, total_iters = create_train_val_dataloaders(opt, logger)
    model = build_model(opt, device=device)

    start_epoch, current_iter = 0, 0
    if resume_state_path:
        meta = model.resume_training(resume_state_path)
        start_epoch, current_iter = meta["epoch"], meta["iter"]
        logger.info(f"Resuming training from epoch {start_epoch}, iter {current_iter}.")

    msg_logger = MessageLogger(opt)
    interrupted = {"flag": False}

    def _sigint(_sig, _frame):
        interrupted["flag"] = True
        logger.warning("SIGINT received; saving and exiting after this iteration.")

    try:
        previous = signal.signal(signal.SIGINT, _sigint)
    except ValueError:  # not the main thread
        previous = None

    def every(freq: int | None) -> bool:
        return bool(freq) and current_iter % freq == 0

    iter_timer = AvgTimer()
    train_ds_opt = next(d for k, d in opt.datasets.items() if k.split("_")[0] == "train")
    if train_ds_opt.device_cache:
        from trainner_redux_tpu_torch.data.device_cache import DeviceCacheFeeder

        # the images on the card and each batch cut there; next() never ends
        # an epoch (sampling with replacement), the iteration count does
        prefetcher = DeviceCacheFeeder(train_loader.dataset, train_ds_opt,
                                       train_loader.batch_size, device, opt.manual_seed or 0)
        logger.info(f"Device dataset cache active: batches of {train_loader.batch_size} are "
                    "cut on the device.")
    else:
        prefetcher = DevicePrefetcher(train_loader, device)
    logger.info(f"Start training from epoch: {start_epoch}, iter: {current_iter}")
    epoch = start_epoch
    try:
        while current_iter < total_iters and not interrupted["flag"]:
            train_loader.set_epoch(epoch)
            prefetcher.reset()
            while (current_iter < total_iters and not interrupted["flag"]
                   and (train_data := prefetcher.next()) is not None):
                current_iter += 1
                model.feed_data(train_data)
                model.optimize_parameters(current_iter)
                iter_timer.record()
                if opt.logger and every(opt.logger.print_freq):
                    log_vars = {
                        "epoch": epoch, "iter": current_iter,
                        "lrs": model.get_current_learning_rate(),
                        "time_sec_avg": iter_timer.get_avg_time(),
                    }
                    log_vars.update(model.get_current_log())
                    msg_logger(log_vars)
                if opt.logger and every(opt.logger.save_checkpoint_freq):
                    logger.info("Saving models and training states.")
                    model.save(epoch, current_iter)
                if opt.val and opt.val.val_enabled and every(opt.val.val_freq):
                    for val_loader in val_loaders:
                        model.validation(val_loader, current_iter, None, opt.val.save_img)
            epoch += 1
    except KeyboardInterrupt:
        logger.warning("KeyboardInterrupt: saving before exit.")
    except Exception:
        logger.exception("Training crashed: saving an emergency checkpoint.")
        model.save(epoch, current_iter)
        raise
    finally:
        prefetcher.close()
        if previous is not None:
            signal.signal(signal.SIGINT, previous)

    n_recal = opt.train.bn_recalibrate_batches if opt.train else 0
    if n_recal > 0:
        logger.info(f"Recalibrating BatchNorm statistics over {n_recal} batches.")
        model.recalibrate_bn(train_loader, num_batches=n_recal)

    logger.info("End of training. Saving final models and states.")
    model.save(epoch, current_iter)
    if opt.val and opt.val.val_enabled:
        for val_loader in val_loaders:
            model.validation(val_loader, current_iter, None, opt.val.save_img)
    return model


def train_pipeline(root_path: str = REPO_ROOT, argv: list[str] | None = None, device=None):
    opt, args = parse(root_path, argv)
    return run(opt, device=device, opt_file=args.opt)


if __name__ == "__main__":
    train_pipeline(REPO_ROOT, sys.argv[1:])
