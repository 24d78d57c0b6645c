"""RealESRGANModel: training on pairs degraded on the fly (OTF), on the
device (port of the JAX package's models/realesrgan_model.py).

Each batch of GT crops (gt_size + 32, uint8) and per-sample blur kernels
from `data/realesrgan_dataset.py` goes through `_degrade`, the stages of the
JAX program in its order: optics (lens distortion, chromatic aberration,
motion blur, kernel1), sensor (demosaic, sensor noise, rolling shutter,
Gaussian noise), ISP (exposure, colour temperature, oversharpen, aliasing),
the resize to LQ size in a drawn mode, the final sinc filter, compression
(DiffJPEG, kernel #15 on the card; WebP, AVIF and HEIF are DiffJPEG at
quality offsets 5, 10 and 8), platform recompression, editing, 8-bit
rounding, the clean pass-through, and one random paired crop for the whole
batch. A device ring buffer of `queue_size` pairs (`_pool_step`) then
shuffles pairs across batches, and a degradation sequence plan
(`enable_sequences`) replaces the compression stages when one is drawn.

What the JAX program does is kept, not what upstream traiNNer does:
kernel2 is drawn and unused (no second-order blur), `p_clean` emits the
antialiased bicubic downscale of GT, and `jpeg_prob` is inert (the
compression stage always runs).

The draws. A whole-batch gate, a resize mode, a codec, an aliasing bucket
and the crop offsets pick Python branches and shapes: they come from a host
`torch.Generator`, so no draw waits for the card. Per-sample parameters and
noise come from a `torch.Generator` on the model's device. Both are seeded
from manual_seed + 7919, as the JAX program's key is; torch cannot give
jax.random's numbers, so the tests hold each operator against JAX on the
same inputs and noise, and the whole `_degrade` where nothing is drawn.
The degradation runs in fp32 with TF32 off, as the JAX resize runs at
precision "highest", whatever the compute dtype: with bfloat16 (the
templates' default) only the networks (net_g, and net_d with a GAN) compute
in bf16, on the fp32 pairs.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from trainner_redux_tpu_torch.models.sr_model import SRModel, fp32_math
from trainner_redux_tpu_torch.ops import degradations as D
from trainner_redux_tpu_torch.ops.resize import gaussian_blur, resize
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.registry import MODEL_REGISTRY

# quality offset of each codec's DiffJPEG surrogate
CODEC_OFFSETS = {"jpeg": 0.0, "webp": 5.0, "avif": 10.0, "heif": 8.0}
# the modern codecs' steps of a sequence plan
_PLAN_CODEC_OFFSETS = {f"{c}_compression": q for c, q in CODEC_OFFSETS.items() if c != "jpeg"}


@MODEL_REGISTRY.register()
class RealESRGANModel(SRModel):
    def __init__(self, opt: ReduxOptions, device: str | torch.device | None = None) -> None:
        if int(opt.steps_per_dispatch or 1) > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is not supported with the on-the-fly degradation "
                "models: the degradation program and the pair pool take flat (B, ...) batches"
            )
        super().__init__(opt, device)
        self.queue_size = int(opt.queue_size)
        self._pool: dict[str, Any] | None = None
        self._feed_count = 0
        seed = (opt.manual_seed or 0) + 7919
        self.host_generator = torch.Generator().manual_seed(seed)
        self.device_generator = torch.Generator(device=self.device).manual_seed(seed)

        self.sequence_controller = None
        if opt.enable_sequences:
            from trainner_redux_tpu_torch.models.paragon_sequences import (
                SequenceController,
                sequences_for_set,
            )

            self.sequence_controller = SequenceController(
                sequences_for_set(opt.sequence_set), seed=opt.manual_seed or 0
            )
            self._seq_rng = np.random.default_rng([opt.manual_seed or 0, 515151])

    # ------------------------------------------------------------------
    # draws
    # ------------------------------------------------------------------

    def _gate(self, prob: float) -> bool:
        """One whole-batch Bernoulli draw on the host: never below 0, always
        from 1 on."""
        if prob <= 0:
            return False
        if prob >= 1:
            return True
        return float(torch.rand((), generator=self.host_generator)) < prob

    def _choice(self, weights) -> int:
        """An index drawn on the host with probability proportional to
        `weights`."""
        w = torch.as_tensor(np.asarray(weights, np.float64))
        return int(torch.multinomial(w / w.sum(), 1, generator=self.host_generator))

    def _randint(self, high: int) -> int:
        """A host draw in [0, high)."""
        return int(torch.randint(high, (), generator=self.host_generator))

    def _uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor:
        """Uniform in [lo, hi) on the device, per sample."""
        u = torch.rand(shape, generator=self.device_generator, device=self.device)
        return u * (hi - lo) + lo

    def _normal(self, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self.device_generator, device=self.device)

    def _crop_offsets(self, h_lq: int, w_lq: int, lq_patch: int) -> tuple[int, int]:
        """(top, left) of the batch's paired crop, in LQ pixels."""
        return self._randint(h_lq - lq_patch + 1), self._randint(w_lq - lq_patch + 1)

    def _crop(self, gt: torch.Tensor, lq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        gt_size = self.opt.datasets["train"].gt_size  # the OTF dataset requires it
        top, left = self._crop_offsets(lq.shape[1], lq.shape[2], gt_size // self.scale)
        return D.paired_random_crop_device(gt, lq, gt_size, self.scale, top, left)

    def _compress(self, x: torch.Tensor, fmt: str) -> torch.Tensor:
        lo, hi = getattr(self.opt, f"compression_{fmt}_range")
        q = self._uniform((x.shape[0],), lo, hi)
        return D.compress_jpeg_like(x, q, CODEC_OFFSETS[fmt])

    # ------------------------------------------------------------------
    # the degradation program
    # ------------------------------------------------------------------

    def _degrade(self, gt: torch.Tensor, kernel1: torch.Tensor, kernel2: torch.Tensor,
                 sinc_kernel: torch.Tensor,
                 skip_compression: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, gt_size + 32, gt_size + 32, 3) GT -> the cropped (gt, lq) pair,
        NHWC float in [0, 1], lq on the 8-bit grid. kernel2 is taken and
        unused, as in the JAX program."""
        del kernel2
        if gt.dtype == torch.uint8:
            gt = gt.float() / 255.0
        opt = self.opt
        b, ori_h, ori_w, _ = gt.shape
        out = gt

        # stage 1: optics
        if self._gate(opt.lens_distort_prob):
            out = D.apply_lens_distortion(out, self._uniform((b,), *opt.lens_distort_strength_range))
        if self._gate(opt.chromatic_aberration_prob):
            out = D.apply_chromatic_aberration(out, self._uniform((b,), 0.5, 2.0))
        if self._gate(opt.motion_blur_prob):
            angle = self._uniform((b,), *opt.motion_blur_angle_range)
            ksize = int(opt.motion_blur_kernel_size[1]) | 1
            out = D.filter2d(out, D.motion_blur_kernel(ksize, angle))
        if self._gate(opt.blur_prob):
            out = D.filter2d(out, kernel1)

        # stage 2: sensor
        if self._gate(opt.demosaic_prob):
            out = D.apply_demosaic_artifacts(out)
        if self._gate(opt.sensor_noise_prob):
            std = self._uniform((b, 1, 1, 1), *opt.sensor_noise_std_range)
            out = D.apply_sensor_noise(out, self._normal(out.shape), self._normal(out.shape), std)
        if self._gate(opt.rolling_shutter_prob):
            out = D.apply_rolling_shutter(
                out, self._uniform((b, 1), *opt.rolling_shutter_strength_range))
        # the classic Gaussian noise knobs, kept for config parity
        if self._gate(opt.gaussian_noise_prob):
            lo, hi = opt.noise_range
            sigma = self._uniform((b,), lo / 255.0, max(hi, lo + 1e-6) / 255.0)
            gray = self._uniform((b,), 0.0, 1.0) < opt.gray_noise_prob
            out = D.add_gaussian_noise(out, self._normal(out.shape), self._normal((*out.shape[:3], 1)),
                                       sigma, gray)

        # stage 3: ISP
        if self._gate(opt.exposure_prob):
            out = D.apply_exposure(out, self._uniform((b, 1, 1, 1), *opt.exposure_factor_range))
        if self._gate(opt.color_temp_prob):
            out = D.apply_color_temperature(
                out, self._uniform((b, 1, 1), *opt.color_temp_shift_range))
        if self._gate(opt.oversharpen_prob):
            out = D.apply_oversharpen(out, self._uniform((b, 1, 1, 1), *opt.oversharpen_strength))
        if self._gate(opt.aliasing_prob):
            out = D.apply_aliasing(out, tuple(opt.aliasing_scale_range),
                                   self._randint(D.ALIASING_BUCKETS))

        # the resize to LQ size in a drawn mode, then the anti-aliasing sinc
        lq_h, lq_w = ori_h // self.scale, ori_w // self.scale
        mode = opt.resize_mode_list3[self._choice(opt.resize_mode_prob3)]
        out = torch.clamp(resize(out, (lq_h, lq_w), mode=mode), 0.0, 1.0)
        out = D.filter2d(out, sinc_kernel)

        if skip_compression:
            # a degradation sequence replaces the compression stages
            return self._crop(gt, D.round_to_uint8(out))

        # stage 4: compression (jpeg and the modern-codec surrogates)
        out = self._compress(out, opt.compression_formats[self._choice(opt.compression_weights)])
        # stage 6: platform recompression
        if opt.recompression_prob > 0:
            fmt = opt.recompression_formats[self._choice(opt.recompression_weights)]
            if self._gate(opt.recompression_prob):
                out = self._compress(out, fmt)

        # stage 5: editing
        if opt.editing_prob > 0 and self._gate(opt.editing_prob):
            if self._gate(opt.editing_exposure_prob):
                factor = self._uniform((), *opt.editing_exposure_range)
                out = torch.clamp(out * factor, 0.0, 1.0)
            if self._gate(opt.editing_oversharpen_prob):
                out = D.apply_oversharpen(
                    out, self._uniform((b, 1, 1, 1), *opt.editing_oversharpen_strength))

        lq = D.round_to_uint8(out)
        # clean pass-through: the antialiased bicubic downscale of GT (a
        # static-shape stand-in for upstream's full-size GT), 8-bit rounded
        if self._gate(opt.p_clean):
            lq = D.round_to_uint8(resize(gt, (lq_h, lq_w), mode="bicubic", antialias=True))
        return self._crop(gt, lq)

    # ------------------------------------------------------------------
    # the training-pair pool (a device ring buffer)
    # ------------------------------------------------------------------

    def _pool_step(self, pool_lq: torch.Tensor, pool_gt: torch.Tensor, count: int,
                   lq: torch.Tensor, gt: torch.Tensor, perm: torch.Tensor | None):
        """(pool_lq, pool_gt, count, out_lq, out_gt). Until the pool holds
        queue_size pairs the batch goes in at `count` and trains as it is;
        then the pool is reordered by `perm` (a permutation of queue_size),
        its first B pairs train and the batch takes their place."""
        b = lq.shape[0]
        if count >= self.queue_size:
            pool_lq, pool_gt = pool_lq[perm], pool_gt[perm]
            out_lq, out_gt = pool_lq[:b].clone(), pool_gt[:b].clone()
            pool_lq[:b], pool_gt[:b] = lq, gt
            return pool_lq, pool_gt, count, out_lq, out_gt
        pool_lq[count : count + b], pool_gt[count : count + b] = lq, gt
        return pool_lq, pool_gt, count + b, lq, gt

    # ------------------------------------------------------------------
    # degradation sequence plans
    # ------------------------------------------------------------------

    def _apply_plan(self, lq: torch.Tensor, plan: list[tuple[str, dict]]) -> torch.Tensor:
        """Run a degradation-sequence plan (op names of upstream's sequence
        vocabulary, paragon_sequences.py) on lq; 8-bit rounded."""
        b = lq.shape[0]

        def full(shape, v):
            return torch.full(shape, float(v), device=lq.device)

        for op, params in plan:
            if op in ("jpeg", "recompress_jpeg", "jpeg_compression"):
                lq = D.diff_jpeg_clip(lq, full((b,), params.get("quality", 75.0)))
            elif op in _PLAN_CODEC_OFFSETS:
                q = float(params.get("quality", 75.0)) + _PLAN_CODEC_OFFSETS[op]
                lq = D.diff_jpeg_clip(lq, full((b,), min(q, 99.0)))
            elif op == "blur":
                lq = torch.clamp(gaussian_blur(lq, 7, float(params.get("sigma", 1.0))), 0.0, 1.0)
            elif op == "motion_blur":
                ksize = int(params.get("kernel_size", 5)) | 1
                angle = torch.tensor(float(params.get("angle", 0.0)), device=lq.device)
                lq = D.filter2d(lq, D.motion_blur_kernel(ksize, angle))
            elif op == "sensor_noise":
                lq = D.apply_sensor_noise(lq, self._normal(lq.shape), self._normal(lq.shape),
                                          full((b, 1, 1, 1), params.get("std", 0.02)))
            elif op in ("oversharpen", "oversharpening"):
                lq = D.apply_oversharpen(lq, full((b, 1, 1, 1), params.get("strength", 1.2)))
            elif op in ("exposure", "exposure_error"):
                lq = D.apply_exposure(lq, full((b, 1, 1, 1), params.get("factor", 1.0)))
            elif op == "color_temp_shift":
                lq = D.apply_color_temperature(lq, full((b, 1, 1), params.get("shift", 0.0)))
            elif op == "lens_distortion":
                lq = D.apply_lens_distortion(lq, full((b,), params.get("strength", 0.05)))
            elif op == "rolling_shutter":
                lq = D.apply_rolling_shutter(lq, full((b, 1), params.get("strength", 0.03)))
            elif op == "chromatic_aberration":
                lq = D.apply_chromatic_aberration(lq, full((b,), params.get("strength", 1.0)))
            elif op == "demosaicing":
                lq = D.apply_demosaic_artifacts(lq)
            elif op == "video_compression":
                lq = D.apply_video_codec_artifacts(lq, float(params.get("crf", 28.0)))
            elif op == "block_artifacts":
                lq = D.apply_block_artifacts(lq, float(params.get("strength", 12.0)))
            elif op == "color_banding":
                lq = D.apply_color_banding(lq, float(params.get("bits", 7)))
            elif op == "ringing":
                lq = D.apply_ringing(lq, float(params.get("strength", 0.05)))
            else:
                raise ValueError(
                    f"unknown degradation op {op!r} in a sequence plan; the ops follow "
                    "upstream's sequence vocabulary (paragon_sequences.py), and a typo would "
                    "silently weaken the degradations"
                )
        return D.round_to_uint8(lq)

    # ------------------------------------------------------------------

    def feed_data(self, data: dict[str, Any]) -> None:
        """An OTF batch (gt and the three kernels) is degraded on the device
        into the (lq, gt) pair that trains; anything else is SRModel's."""
        if not (self.is_train and "kernel1" in data):
            super().feed_data(data)
            return
        gt, k1, k2, sinc = (torch.as_tensor(data[k]).to(self.device, non_blocking=True)
                            for k in ("gt", "kernel1", "kernel2", "sinc_kernel"))
        self._feed_count += 1
        plan = None
        if (self.sequence_controller is not None
                and self._seq_rng.uniform() < self.opt.sequence_probability):
            plan = self.sequence_controller.plan()
        with torch.no_grad(), fp32_math(self.opt.fast_matmul):
            gt, lq = self._degrade(gt, k1, k2, sinc, skip_compression=bool(plan))
            if plan:
                lq = self._apply_plan(lq, plan)
            if self.queue_size > 0:
                gt, lq = self._through_pool(gt, lq)

        # the OTF debug dumps: each degraded pair under debug/otf, up to the
        # limit (0: no limit)
        limit = int(self.opt.high_order_degradations_debug_limit or 0)
        if self.opt.high_order_degradations_debug and (not limit or self._feed_count <= limit):
            from trainner_redux_tpu_torch.utils.img_util import save_batch_grid

            os.makedirs("debug/otf", exist_ok=True)
            save_batch_grid(lq, f"debug/otf/{self._feed_count:06d}_otf_lq.png")
            save_batch_grid(gt, f"debug/otf/{self._feed_count:06d}_otf_gt.png")
        self.lq, self.gt = lq, gt

    def _through_pool(self, gt: torch.Tensor, lq: torch.Tensor):
        b = lq.shape[0]
        if self.queue_size % b:
            raise ValueError(f"queue_size {self.queue_size} must be a multiple of batch {b}")
        if self._pool is None:
            self._pool = {"lq": lq.new_zeros((self.queue_size, *lq.shape[1:])),
                          "gt": gt.new_zeros((self.queue_size, *gt.shape[1:])), "count": 0}
        perm = None
        if self._pool["count"] >= self.queue_size:
            perm = torch.randperm(self.queue_size, generator=self.device_generator,
                                  device=self.device)
        plq, pgt, count, lq, gt = self._pool_step(self._pool["lq"], self._pool["gt"],
                                                  self._pool["count"], lq, gt, perm)
        self._pool = {"lq": plq, "gt": pgt, "count": count}
        return gt, lq

    def _extra_training_state(self) -> dict:
        return {"otf_host_generator": self.host_generator.get_state(),
                "otf_device_generator": self.device_generator.get_state(),
                "otf_feed_count": self._feed_count}

    def _load_extra_training_state(self, state: dict) -> None:
        if "otf_host_generator" in state:
            self.host_generator.set_state(state["otf_host_generator"])
            self.device_generator.set_state(state["otf_device_generator"])
            self._feed_count = int(state["otf_feed_count"])


@MODEL_REGISTRY.register()
class RealESRGANPairedModel(RealESRGANModel):
    """Per iteration, a paired LR/HR batch with probability
    `dataroot_lq_prob`, else the OTF batch."""

    def feed_data(self, data: dict[str, Any]) -> None:
        rng = np.random.default_rng([self.opt.manual_seed or 0, 104729, self._feed_count])
        if self.is_train and "paired_lq" in data and rng.uniform() < self.opt.dataroot_lq_prob:
            SRModel.feed_data(self, {"lq": data["paired_lq"], "gt": data["paired_gt"]})
            return
        super().feed_data(data)
