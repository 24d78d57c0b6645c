"""SRModel: single-image super-resolution, serving and training.

Port of the JAX package's models/sr_model.py.

- Evaluation (`is_train: false`, the `test.py` path): `__init__` (network,
  seeded init, pretrained weights), `load_network` for the three checkpoint
  formats, `test` (reflect-pad to a multiple of 16, one forward, crop) and
  `nondist_validation` (per image: save PNG, PSNR/SSIM).
- Training (the `train.py` path), in the compute dtype of the JAX package's
  policy (`compute_dtype: bfloat16`, its default, and `use_amp` give bf16;
  `compute_dtype: float32` fp32): the network is built with it
  (`build_network_cast`) and computes its training forward in it, from fp32
  parameters that take fp32 gradients and fp32 optimizer and EMA updates;
  validation, `test` and the EMA network's forward run the same parameters
  in fp32, the JAX package's fp32 twin. bf16 trains SwinIR (on the bf16
  forms of #4/#5, SwinIR-L on those of #3/#8), HAT (#3/#8, #2/#7), DAT
  (the rect #3/#8), SRFormerV2 (#1/#6 at 12x12, #2/#7), Swin2SR (the
  bf16 forms of #11-#14) and the conv families (SPAN, SPANF, SPANPlus,
  SpanC, Compact, ESRGAN: cuDNN, no kernel), and a GAN's
  DUnet computes in the same dtype (no twin: D only trains). fp32 runs
  with TF32 off (`fast_matmul`
  lets cuBLAS and cuDNN use TF32; `deterministic` runs the step on torch's
  deterministic algorithms; `detect_anomaly` under autograd's anomaly
  detection, so a NaN in the backward raises): pair losses (a dict loss,
  hsluv's, summed and logged term by term), the
  torch optimizer with optax's semantics and a step -> lr schedule,
  `accum_iter` micro-batches with averaged gradients, the logged global
  gradient norm, optional clipping, EMA with the warm-up power decay and
  `ema_switch_iter`, checkpoints and resume, and the post-training
  BatchNorm recalibration (`recalibrate_bn`). Validation runs the EMA
  weights when there are any.
- GAN training (a `ganloss` / `multiscaleganloss` loss and `network_d:
  dunet`), as the JAX step has it: the generator's GAN term
  |loss_weight| * ganloss(D(output), real) through D in train mode with
  D's parameters frozen; then, after the generator's update, the
  discriminator's step on the generator forward's own output (detached;
  with `accum_iter`, micro-batch 0's output and GT), with the weights of
  before the step: l_d_real + l_d_fake, its own optimizer (`optim_d`, else
  `optim_g`) and `grad_clip`, then one refresh of each spectral norm's
  (u, v) from those weights (from the fp32 weights in bf16 too, as the
  JAX refresh computes them). D takes the generator's fp32 output and the
  fp32 GT and returns fp32 logits, which the GAN loss takes. D's learning rate is its schedule at D's own
  count of updates, as optax counts them (the logged lr_d is at the global
  step, as the JAX step logs it). With
  `adaptive_d`, the step and the refresh are skipped while the smoothed
  generator GAN loss rises.

DropPath draws from one `torch.Generator` on the model's device, seeded from
`manual_seed`, that the model hands to the network.

Not ported yet, and refused where configured: `steps_per_dispatch > 1`, `remat`, discriminators other than
DUnet, the R3GAN and feature-matching losses, MoA, dynamic loss
scheduling, training automations, tiled inference and the mesh-sharded
paths.
"""

from __future__ import annotations

import copy
import math
import os
from contextlib import ExitStack, contextmanager
from os import path as osp
from typing import Any

import numpy as np
import torch

from trainner_redux_tpu_torch.archs import build_network_cast
from trainner_redux_tpu_torch.archs.arch_util import refresh_spectral_norms
from trainner_redux_tpu_torch.losses import build_loss, loss_log_key
from trainner_redux_tpu_torch.metrics import calculate_metric
from trainner_redux_tpu_torch.models.base_model import BaseModel
from trainner_redux_tpu_torch.optimizers import build_optimizer, clip_by_global_norm, set_lr
from trainner_redux_tpu_torch.utils.img_util import imwrite, tensor2img
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.registry import MODEL_REGISTRY

_PAD_MULT = 16
_NOT_PORTED = "is not ported to torch yet (ROADMAP.md, section 1)"
GAN_LOSS_TYPES = {"ganloss", "multiscaleganloss"}
DISCRIMINATORS = {"dunet"}  # the ported network_d types

# legacy per-loss option keys and the type each defaults to (None: the dict
# must name its type), as the JAX package reads them
_LEGACY_LOSSES = {
    "pixel_opt": None, "mssim_opt": "mssimloss", "perceptual_opt": "perceptualloss",
    "dists_opt": "distsloss", "ldl_opt": "ldlloss", "hsluv_opt": "hsluvloss",
    "gan_opt": "ganloss", "color_opt": "colorloss", "luma_opt": "lumaloss",
    "avg_opt": "averageloss", "bicubic_opt": "bicubicloss",
    "ms_ssim_l1_opt": "msssiml1loss", "contextual_opt": "contextualloss",
    "hr_inversion_opt": None, "dinov2_opt": "dinoperceptualloss",
    "topiq_opt": None, "pd_opt": None, "fd_opt": None,
}


@contextmanager
def fp32_math(fast: bool = False):
    """Full fp32 matmuls and convolutions (TF32 off), as the JAX package's
    fp32 twin computes; with `fast` (the `fast_matmul` option, JAX's
    "fastest" matmul precision) cuBLAS and cuDNN may take TF32. Either way
    the hand-written kernels compute as they always do: the switch reaches
    only cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = fast
    torch.backends.cudnn.allow_tf32 = fast
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms (an op that has none raises), cuDNN's
    deterministic convolutions and no cuDNN benchmark; restored after. The
    hand-written kernels need no switch: they use no atomics."""
    cudnn = torch.backends.cudnn
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.deterministic,
           cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        cudnn.deterministic, cudnn.benchmark = old[2], old[3]


@contextmanager
def step_math(opt: ReduxOptions):
    """What a training step runs under, as the options ask: `fp32_math` (TF32
    with `fast_matmul`), `deterministic_algorithms` with `deterministic`,
    and with `detect_anomaly` autograd's anomaly detection, so that a NaN
    in the backward raises, as `jax_debug_nans` makes the JAX step raise."""
    with ExitStack() as stack:
        stack.enter_context(fp32_math(opt.fast_matmul))
        if opt.deterministic:
            stack.enter_context(deterministic_algorithms())
        if opt.detect_anomaly:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        yield


def _nchw_float(x: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 [0, 255] or float [0, 1] -> NCHW float32 [0, 1]."""
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return x.permute(0, 3, 1, 2)


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: ReduxOptions, device: str | torch.device | None = None) -> None:
        super().__init__(opt, device)
        if opt.network_g is None:
            raise ValueError("network_g is required")
        if opt.input_pixel_format != "rgb" or opt.output_pixel_format != "rgb":
            raise NotImplementedError(f"non-rgb pixel formats: this {_NOT_PORTED}")
        if opt.val and opt.val.tile_size:
            raise NotImplementedError(f"tiled inference {_NOT_PORTED}")
        self.scale = opt.scale
        net = build_network_cast({**opt.network_g, "scale": opt.scale}, self.compute_dtype)
        generator = torch.Generator().manual_seed(opt.manual_seed or 0)
        net.init_weights(generator)
        self.logger.info(
            f"Network [bold]{type(net).__name__}[/bold] created, "
            f"{self.param_count(net):,d} params."
        )
        if opt.path.pretrain_network_g:
            self.load_network(net, opt.path.pretrain_network_g, strict=opt.path.strict_load_g)
        self.net_g = net.to(self.device)
        self.net_g_ema: torch.nn.Module | None = None
        self.net_d: torch.nn.Module | None = None
        self.output = None
        self.lq = self.gt = None
        if self.is_train:
            self._init_training()
        else:
            self.net_g.eval()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _init_training(self) -> None:
        opt = self.opt
        train_opt = opt.train
        if train_opt is None:
            raise ValueError("training needs a `train` section")
        self._refuse_unported()

        self.ema_decay = float(train_opt.ema_decay or 0.0)
        self.ema_update_after_step = int(train_opt.ema_update_after_step or 0)
        self.ema_power = float(train_opt.ema_power or 10)
        self.ema_switch_iter = int(train_opt.ema_switch_iter or 0)
        self.grad_clip = bool(train_opt.grad_clip)
        train_ds = next((d for k, d in opt.datasets.items() if k.split("_")[0] == "train"), None)
        self.accum_iter = int(train_ds.accum_iter) if train_ds else 1

        loss_opts = list(train_opt.losses or [])
        for attr, default_type in _LEGACY_LOSSES.items():
            lo = getattr(train_opt, attr, None)
            if lo:
                lo = dict(lo)
                if "type" not in lo:
                    if default_type is None and attr != "pixel_opt":
                        raise ValueError(f"legacy loss option {attr!r} must define 'type'")
                    lo["type"] = default_type or "l1loss"
                loss_opts.append(lo)
        self.losses: list[tuple[str, Any]] = []
        self.gan_losses: list[Any] = []
        for lo in loss_opts:
            ltype = str(lo["type"]).lower()
            loss = build_loss(lo)
            if ltype in GAN_LOSS_TYPES:
                self.gan_losses.append(loss)
                continue
            if loss.loss_weight < 0:
                raise NotImplementedError(f"negative loss weights (bicubic targets) {_NOT_PORTED}")
            self.losses.append((loss_log_key(loss, ltype), loss))

        self.net_g.train()
        self.optimizer_g, self.schedule_g = build_optimizer(
            self.net_g.parameters(), train_opt.optim_g or {"type": "Adam", "lr": 1e-4},
            int(train_opt.total_iter), train_opt.scheduler, train_opt.warmup_iter,
        )
        if self.ema_decay > 0:
            self.net_g_ema = copy.deepcopy(self.net_g).eval().requires_grad_(False)
        if self.gan_losses:
            self._init_discriminator()
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            opt.manual_seed or 0
        )
        if hasattr(self.net_g, "set_dropout_generator"):
            self.net_g.set_dropout_generator(self.dropout_generator)
        self.step = 0
        self.log_dict: dict[str, torch.Tensor] = {}

    def _init_discriminator(self) -> None:
        """network_d, seeded from manual_seed + 1 (and its pretrained
        weights), its optimizer and schedule, and the adaptive-D state."""
        opt, train_opt = self.opt, self.opt.train
        if opt.network_d is None:
            raise ValueError("GAN losses require network_d")
        net_d = build_network_cast(dict(opt.network_d), self.compute_dtype)
        net_d.init_weights(torch.Generator().manual_seed((opt.manual_seed or 0) + 1))
        if opt.path.pretrain_network_d:
            self.load_network(net_d, opt.path.pretrain_network_d, strict=opt.path.strict_load_d)
        self.logger.info(
            f"Network [bold]{type(net_d).__name__}[/bold] created, "
            f"{self.param_count(net_d):,d} params."
        )
        self.net_d = net_d.to(self.device).train()
        self.optimizer_d, self.schedule_d = build_optimizer(
            self.net_d.parameters(),
            train_opt.optim_d or train_opt.optim_g or {"type": "Adam", "lr": 1e-4},
            int(train_opt.total_iter), train_opt.scheduler, train_opt.warmup_iter,
        )
        self.adaptive_d = bool(train_opt.adaptive_d)
        self.adaptive_d_decay = float(train_opt.adaptive_d_ema_decay)
        self.adaptive_d_threshold = float(train_opt.adaptive_d_threshold)
        self.gan_ema = torch.zeros((), device=self.device)

    def _bf16_refusal(self) -> str | None:
        """Why this model cannot train in bf16 on the port, or None: the
        network says (its `bf16_refusal`, which names the kernels it
        lacks); a network without one is refused. DUnet, the one ported
        discriminator, has its bf16 form."""
        refusal = getattr(self.net_g, "bf16_refusal", None)
        if refusal is None:
            return f"{type(self.net_g).__name__} (it has no bf16 form)"
        return refusal()

    def _refuse_unported(self) -> None:
        opt, train_opt = self.opt, self.opt.train
        if self.compute_dtype == torch.bfloat16:
            why = self._bf16_refusal()
            if why:
                raise NotImplementedError(
                    f"bf16 training (compute_dtype: bfloat16, its default, or use_amp) of {why} "
                    f"{_NOT_PORTED}; set compute_dtype: float32")
        if opt.deterministic:
            # cuBLAS is deterministic only with this workspace, set before its first use
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        refused = {
            "steps_per_dispatch > 1": (opt.steps_per_dispatch or 1) > 1,
            "remat": bool(opt.remat),
            f"network_d type '{(opt.network_d or {}).get('type')}' (only "
            f"{', '.join(sorted(DISCRIMINATORS))} is ported)": (
                opt.network_d is not None
                and str(opt.network_d.get("type")).lower() not in DISCRIMINATORS),
            "use_moa": bool(train_opt.use_moa),
            "dynamic_loss_scheduling": bool(
                (train_opt.dynamic_loss_scheduling or {}).get("enabled", False)),
            "training_automations": bool(
                (train_opt.training_automations or {}).get("enabled", False)),
        }
        for what, on in refused.items():
            if on:
                raise NotImplementedError(f"{what} {_NOT_PORTED}")

    def _generator_losses(self, output: torch.Tensor, gt: torch.Tensor):
        """(total, logs) of the generator's losses on one micro-batch: the
        pair losses (a dict loss's terms each logged under its key), then
        each GAN term |weight| * ganloss(D(output), real), logged as
        l_g_gan; its unweighted value goes to logs["raw_gan"]."""
        logs: dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=output.device)
        for log_key, loss in self.losses:
            val = loss(output, gt)
            # a dict loss (hsluv) logs each term apart, as the JAX step does
            for key, v in (val.items() if isinstance(val, dict) else [(None, val)]):
                v = v.float()
                logs[log_key if key is None else f"{log_key}_{key}"] = v
                total = total + v
        for loss in self.gan_losses:
            raw = loss(self.net_d(output), True, is_disc=False)
            logs["raw_gan"] = raw.detach()
            val = abs(loss.loss_weight) * raw
            logs["l_g_gan"] = val
            total = total + val
        logs["l_g_total"] = total
        return total, logs

    def _discriminator_step(self, fake: torch.Tensor, gt: torch.Tensor,
                            raw_gan: torch.Tensor | None, logs: dict) -> None:
        """D's step on the detached `fake` and `gt`, from the weights of
        before it: l_d_real + l_d_fake, the update, and the refresh of each
        spectral norm from those weights; with adaptive_d, skipped (no
        update, no refresh, the optimizer state unchanged) while the
        smoothed generator GAN loss rises."""
        net_d = self.net_d
        skip = False
        if self.adaptive_d:
            prev = self.gan_ema
            cand = raw_gan if self.step == 0 else (
                self.adaptive_d_decay * prev + (1.0 - self.adaptive_d_decay) * raw_gan)
            skip = self.step > 0 and bool(cand > prev * self.adaptive_d_threshold)
            self.gan_ema = cand
            logs["adaptive_d_skip"] = torch.tensor(float(skip))
        net_d.requires_grad_(True)
        self.optimizer_d.zero_grad(set_to_none=True)
        total = torch.zeros((), device=fake.device)
        for loss in self.gan_losses:
            real_pred, fake_pred = net_d(gt), net_d(fake)
            l_real = loss(real_pred, True, is_disc=True)
            l_fake = loss(fake_pred, False, is_disc=True)
            rp = real_pred[-1] if isinstance(real_pred, (list, tuple)) else real_pred
            fp = fake_pred[-1] if isinstance(fake_pred, (list, tuple)) else fake_pred
            logs.update(l_d_real=l_real.detach(), l_d_fake=l_fake.detach(),
                        out_d_real=rp.detach().mean(), out_d_fake=fp.detach().mean())
            total = total + l_real + l_fake
        total.backward()
        logs["lr_d"] = torch.tensor(float(self.schedule_d(self.step)))
        if skip:
            return
        with torch.no_grad():
            grads = []
            for p in net_d.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if self.grad_clip:
                clip_by_global_norm(grads, torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            refresh_spectral_norms(net_d)
            # optax evaluates the schedule at its own count of updates, which
            # adaptive-D skips hold back; the logged lr_d is of the global step
            state = next(iter(self.optimizer_d.state.values()), {})
            set_lr(self.optimizer_d, float(self.schedule_d(int(state.get("step", 0)))))
            self.optimizer_d.step()

    def feed_data(self, data: dict[str, Any]) -> None:
        """Take a batch's lq and gt, NHWC numpy arrays or tensors (uint8 or
        [0, 1] float), onto the model's device; converted in the step."""
        def put(v):
            return None if v is None else torch.as_tensor(v).to(self.device, non_blocking=True)

        self.lq, self.gt = put(data["lq"]), put(data.get("gt"))

    def ema_decay_at(self, step: int) -> float:
        """decay_t = min(decay, 1 - (1 + t)^-power), t = step - after; 0 until
        `ema_update_after_step`, so the first update copies the weights."""
        if step <= self.ema_update_after_step:
            return 0.0
        t = step - self.ema_update_after_step
        return min(self.ema_decay, 1.0 - (1.0 + t) ** (-self.ema_power))

    def optimize_parameters(self, current_iter: int) -> None:
        """One optimizer step on the fed batch, split into `accum_iter`
        micro-batches whose gradients and logs are averaged."""
        lq, gt = _nchw_float(self.lq), _nchw_float(self.gt)
        accum = self.accum_iter
        if lq.shape[0] % accum:
            raise ValueError(f"batch {lq.shape[0]} does not split into {accum} micro-batches")
        params = list(self.net_g.parameters())
        self.optimizer_g.zero_grad(set_to_none=True)
        logs: dict[str, torch.Tensor] = {}
        d_batch = None
        if self.net_d is not None:
            self.net_d.train().requires_grad_(False)  # no G gradient reaches D
        with step_math(self.opt):
            for lq_mb, gt_mb in zip(lq.chunk(accum), gt.chunk(accum)):
                output = self.net_g(lq_mb)
                total, mb_logs = self._generator_losses(output, gt_mb)
                total.backward()
                if d_batch is None:  # D sees micro-batch 0, as in the JAX step
                    d_batch = (output.detach(), gt_mb)
                for k, v in mb_logs.items():
                    logs[k] = logs[k] + v.detach() if k in logs else v.detach()
        with torch.no_grad():
            grads = []
            for p in params:
                if p.grad is None:  # optax updates every parameter, with a zero gradient
                    p.grad = torch.zeros_like(p)
                if accum > 1:
                    p.grad.div_(accum)
                grads.append(p.grad)
            logs = {k: v / accum for k, v in logs.items()}
            g_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            logs["grad_norm_g"] = g_norm
            if self.grad_clip:
                clip_by_global_norm(grads, g_norm)
            lr = float(self.schedule_g(self.step))
            set_lr(self.optimizer_g, lr)
            self.optimizer_g.step()
            if self.net_g_ema is not None:
                d = self.ema_decay_at(self.step)
                ema = list(self.net_g_ema.parameters())
                for e, p in zip(ema, params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
                if self.ema_switch_iter > 0 and (self.step + 1) % self.ema_switch_iter == 0:
                    # the online weights become the EMA weights; the
                    # optimizer moments stay, as upstream
                    for e, p in zip(ema, params):
                        p.copy_(e)
        if self.net_d is not None:
            with step_math(self.opt):
                self._discriminator_step(*d_batch, logs.pop("raw_gan", None), logs)
        logs["lr_g"] = torch.tensor(lr)
        self.step += 1
        self.log_dict = logs

    def get_current_log(self) -> dict[str, float]:
        out = {k: float(v) for k, v in self.log_dict.items() if not k.startswith("lr_")}
        nan_keys = [k for k, v in out.items() if not math.isfinite(v)]
        if "l_g_total" in nan_keys:
            raise RuntimeError(f"NaN/Inf detected in losses: {nan_keys}")
        return out

    def get_current_learning_rate(self) -> list[float]:
        """The lr of the last step, or of the next one before any: G's,
        then D's where there is a D."""
        if "lr_g" in self.log_dict:
            return [float(self.log_dict[k]) for k in ("lr_g", "lr_d") if k in self.log_dict]
        lrs = [float(self.schedule_g(self.step))]
        if self.net_d is not None:
            lrs.append(float(self.schedule_d(self.step)))
        return lrs

    def recalibrate_bn(self, dataloader, num_batches: int = 50) -> None:
        """Refresh every BatchNormNoStats' running statistics, in the online
        and the EMA network, from `num_batches` LQ batches of `dataloader`
        (utils/bn_recalibrate.py). An OTF loader carries GT and kernels
        only: then nothing changes, as in the JAX package."""
        from trainner_redux_tpu_torch.utils.bn_recalibrate import recalibrate_bn

        def batches():
            n = 0
            while n < num_batches:
                got = False
                for data in dataloader:
                    if n >= num_batches or "lq" not in data:
                        return
                    got = True
                    yield _nchw_float(torch.as_tensor(data["lq"]).to(self.device))
                    n += 1
                if not got:
                    return

        for net in (self.net_g, self.net_g_ema):
            if net is None:
                continue
            try:
                with fp32_math(self.opt.fast_matmul):
                    recalibrate_bn(net, batches())
            except ValueError as e:
                self.logger.warning(f"{e}; the BatchNorm statistics are unchanged")
                return

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def _infer_net(self) -> torch.nn.Module:
        """The EMA network when there is one, else the online one."""
        return self.net_g_ema if self.net_g_ema is not None else self.net_g

    def test(self, lq: np.ndarray) -> np.ndarray:
        """Super-resolve NHWC [0,1] numpy images; returns NHWC numpy output."""
        lq = np.asarray(lq)
        if lq.dtype == np.uint8:
            lq = lq.astype(np.float32) / 255.0
        lq = np.asarray(lq, np.float32)
        if lq.ndim == 3:
            lq = lq[None]
        h, w = lq.shape[1], lq.shape[2]
        ph = (_PAD_MULT - h % _PAD_MULT) % _PAD_MULT
        pw = (_PAD_MULT - w % _PAD_MULT) % _PAD_MULT
        if ph or pw:
            lq = np.pad(lq, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect")
        x = torch.from_numpy(np.ascontiguousarray(lq.transpose(0, 3, 1, 2))).to(self.device)
        net = self._infer_net()
        was_training = net.training
        net.eval()
        try:
            with torch.inference_mode(), fp32_math(self.opt.fast_matmul):
                out = net(x)
        finally:
            net.train(was_training)
        out = out[:, :, : h * self.scale, : w * self.scale]
        self.output = out.permute(0, 2, 3, 1).cpu().numpy()
        return self.output

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img) -> None:
        opt = self.opt
        val_opt = opt.val
        dataset_name = dataloader.dataset.opt.name
        with_metrics = bool(val_opt and val_opt.metrics_enabled and val_opt.metrics)
        metric_results: dict[str, float] = {}
        if with_metrics:
            self._init_best_metric_results(dataset_name, val_opt.metrics)
            metric_results = dict.fromkeys(val_opt.metrics, 0.0)

        pbar = None
        if val_opt and val_opt.pbar:
            from tqdm import tqdm

            pbar = tqdm(total=len(dataloader), unit="image")

        count = 0
        for val_data in dataloader:
            sr = self.test(val_data["lq"])[0]
            gt = val_data.get("gt")
            lq_path = val_data["lq_path"]
            img_name = osp.splitext(osp.basename(
                lq_path if isinstance(lq_path, str) else lq_path[0]
            ))[0]
            sr_img = tensor2img(sr.transpose(2, 0, 1))
            count += 1

            if save_img and opt.path.visualization:
                if opt.is_train:
                    save_path = osp.join(
                        opt.path.visualization, img_name, f"{img_name}_{current_iter}.png"
                    )
                else:
                    suffix = val_opt.suffix if val_opt and val_opt.suffix else opt.name
                    save_path = osp.join(
                        opt.path.visualization, dataset_name, f"{img_name}_{suffix}.png"
                    )
                imwrite(sr_img, save_path)

            if with_metrics and gt is not None:
                gt_img = tensor2img(np.asarray(gt)[0].transpose(2, 0, 1))
                data = {
                    "img": sr_img.astype(np.float32) / 255.0,
                    "img2": gt_img.astype(np.float32) / 255.0,
                }
                for name, m_opt in val_opt.metrics.items():
                    m_opt = dict(m_opt)
                    m_opt.pop("better", None)
                    metric_results[name] += calculate_metric(data, m_opt)

            if pbar is not None:
                pbar.update(1)
                pbar.set_description(f"Test {img_name}")

        if pbar is not None:
            pbar.close()
        if with_metrics and count > 0:
            log_str = f"Validation {dataset_name}\n"
            for name in metric_results:
                metric_results[name] /= count
                self._update_best_metric_result(
                    dataset_name, name, metric_results[name], current_iter
                )
                rec = self.best_metric_results[dataset_name][name]
                log_str += (
                    f"\t # {name}: {metric_results[name]:.4f}"
                    f"\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
                )
                if tb_logger:
                    tb_logger.add_scalar(
                        f"metrics/{dataset_name}/{name}", metric_results[name], current_iter
                    )
            self.logger.info(log_str)
            self.metric_results = metric_results

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save(self, epoch: int, current_iter: int) -> None:
        """net_g_ema_<iter> (or net_g_<iter>) under models/, the online
        weights (and net_d_<iter>) under models/resume_models/, and the
        training state."""
        opt = self.opt
        label = "latest" if current_iter == -1 else str(current_iter)
        meta = {
            "framework": "trainner_redux_tpu_torch",
            "arch": opt.network_g.get("type", "?"),
            "scale": str(opt.scale),
        }
        name = "net_g_ema" if self.net_g_ema is not None else "net_g"
        self.save_network_safetensors(
            self._infer_net(), osp.join(opt.path.models, f"{name}_{label}.safetensors"), meta
        )
        self.save_network_safetensors(
            self.net_g, osp.join(opt.path.resume_models, f"net_g_{label}.safetensors"), meta
        )
        if self.net_d is not None:
            self.save_network_safetensors(
                self.net_d, osp.join(opt.path.resume_models, f"net_d_{label}.safetensors"),
                {**meta, "arch": opt.network_d.get("type", "?")},
            )
        if current_iter != -1:
            state = {
                "step": self.step,
                "net_g": self.net_g.state_dict(),
                "optimizer_g": self.optimizer_g.state_dict(),
                "dropout_generator": self.dropout_generator.get_state(),
            }
            if self.net_g_ema is not None:
                state["net_g_ema"] = self.net_g_ema.state_dict()
            if self.net_d is not None:  # its weights with each spectral norm's (u, v)
                state.update(net_d=self.net_d.state_dict(),
                             optimizer_d=self.optimizer_d.state_dict(), gan_ema=self.gan_ema)
            state.update(self._extra_training_state())
            self.save_training_state(state, epoch, current_iter)

    def _extra_training_state(self) -> dict:
        """What a subclass adds to the training state (its generators)."""
        return {}

    def _load_extra_training_state(self, state: dict) -> None:
        """Restore what `_extra_training_state` saved."""

    def resume_training(self, resume_state_path: str) -> dict:
        """Restore the weights, EMA, optimizer, generator and step saved by
        `save` (and D's weights, optimizer and adaptive-D state); returns
        the sidecar's {"epoch", "iter"}."""
        state, meta = self.load_training_state(resume_state_path)
        self.net_g.load_state_dict(state["net_g"])
        if self.net_g_ema is not None:
            self.net_g_ema.load_state_dict(state["net_g_ema"])
        self.optimizer_g.load_state_dict(state["optimizer_g"])
        if self.net_d is not None:
            self.net_d.load_state_dict(state["net_d"])
            self.optimizer_d.load_state_dict(state["optimizer_d"])
            self.gan_ema = state["gan_ema"].to(self.device)
        self.dropout_generator.set_state(state["dropout_generator"])
        self._load_extra_training_state(state)
        self.step = int(state["step"])
        return meta

    def load_network(self, net: torch.nn.Module, path: str, strict: bool = True) -> None:
        """Load weights into `net`: a JAX-framework safetensors (metadata
        `framework: trainner_redux_tpu`, through the weight bridge), a
        torch-layout safetensors, or a .pth/.pt pickle (an upstream
        Swin2SR's q_bias / v_bias packed into the port's qkv bias; either
        torch spectral-norm API's keys; the folded `eval_conv` /
        `conv_3x3_rep` copies of upstream SPAN, SPANPlus and SpanC dropped).
        A JAX-framework file holds parameters only: the net keeps its
        buffers (the spectral norms' (u, v) among them), as the JAX package
        keeps them on such a load."""
        from trainner_redux_tpu_torch.utils import torch_compat

        if path.endswith(".safetensors"):
            from safetensors import safe_open
            from safetensors.numpy import load_file

            with safe_open(path, framework="numpy") as f:
                metadata = f.metadata() or {}
            if metadata.get("framework") == "trainner_redux_tpu":
                template = net.state_dict()
                sd = torch_compat.state_dict_from_jax(load_file(path), type(net).__name__,
                                                      keys=template.keys())
                buffers = {k for k, _ in net.named_buffers()}
                sd.update({k: v for k, v in template.items() if k in buffers and k not in sd})
                self._merge_params(net, sd, strict, path)
                return
        flat = torch_compat.drop_recomputed_buffers(torch_compat.load_torch_state_dict(path))
        flat = torch_compat.drop_folded_copies(flat, net.state_dict().keys())
        flat = torch_compat.canonical_spectral_keys(torch_compat.pack_qkv_bias(flat))
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}
        self._merge_params(net, sd, strict, path)

    def _merge_params(self, net: torch.nn.Module, loaded: dict, strict: bool, path: str) -> None:
        template = net.state_dict()
        missing = set(template) - set(loaded)
        unexpected = set(loaded) - set(template)
        mismatched = {
            k for k in set(template) & set(loaded) if template[k].shape != loaded[k].shape
        }
        if missing or unexpected or mismatched:
            msg = (
                f"Loading {path}: missing={sorted(missing)[:8]} "
                f"unexpected={sorted(unexpected)[:8]} mismatched={sorted(mismatched)[:8]}"
            )
            if strict:
                raise ValueError(msg)
            self.logger.warning(msg)
        usable = {k: v for k, v in loaded.items() if k in template and k not in mismatched}
        net.load_state_dict(usable, strict=False)
