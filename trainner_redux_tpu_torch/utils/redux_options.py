"""Typed, strict configuration schema.

Field-for-field mirror of the reference's config surface
(upstream traiNNer-redux, traiNNer/utils/redux_options.py) so that existing
traiNNer-redux YAML configs parse unchanged, decoded strictly (unknown keys
are errors) through `trainner_redux_tpu_torch.utils.schema`.

A copy of the JAX package's schema, so one YAML serves both packages. Its
TPU-specific additions, grouped at the bottom of `ReduxOptions` (mesh shape,
precision policy, pjit sharding), are decoded and ignored by the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal

PixelFormat = Literal["rgb", "ycbcr", "yuv444", "gray"]


@dataclass
class WandbOptions:
    resume_id: str | None = None
    project: str | None = None


def _default_io_backend() -> dict[str, Any]:
    return {"type": "disk"}


def _default_kernel_list() -> list[str]:
    return ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso", "plateau_aniso"]


def _default_kernel_prob() -> list[float]:
    return [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]


@dataclass
class DatasetOptions:
    """Options for one dataset entry (train/val/test phases)."""

    name: str
    type: str
    io_backend: dict[str, Any] = field(default_factory=_default_io_backend)

    num_worker_per_gpu: int | None = None
    batch_size_per_gpu: int | None = None
    accum_iter: int = 1

    use_hflip: bool = True
    use_rot: bool = True
    mean: list[float] | None = None
    std: list[float] | None = None
    gt_size: int | None = None
    lq_size: int | None = None
    # TPU-native extension (not in the reference): cache decoded uint8 source
    # images in RAM so enlarge-ratio epochs decode each file once.
    cache_decoded: bool | None = None
    # TPU-native extension: keep decoded source images resident in HBM and
    # cut training crops ON DEVICE (data/device_cache.py) — removes the
    # host->device batch transfer from the steady-state loop entirely.
    # Sampling is with-replacement and the augment RNG stream differs from
    # the host loader's; capacity-gated by TRAINNER_DEVICE_CACHE_MB.
    device_cache: bool = False
    color: Literal["y"] | None = None
    phase: str | None = None
    scale: int | None = None
    dataset_enlarge_ratio: Literal["auto"] | int = "auto"
    prefetch_mode: str | None = None
    pin_memory: bool = True
    persistent_workers: bool = True
    num_prefetch_queue: int = 1
    prefetch_factor: int | None = 2

    clip_size: int | None = None

    dataroot_gt: str | list[str] | None = None
    dataroot_lq: str | list[str] | None = None
    meta_info: str | None = None
    filename_tmpl: str = "{}"

    # first-order blur kernel synthesis (Real-ESRGAN OTF)
    blur_kernel_size: int = 12
    kernel_list: list[str] = field(default_factory=_default_kernel_list)
    kernel_prob: list[float] = field(default_factory=_default_kernel_prob)
    kernel_range: tuple[int, int] = (5, 17)
    sinc_prob: float = 0
    blur_sigma: tuple[float, float] = (0.2, 2)
    betag_range: tuple[float, float] = (0.5, 4)
    betap_range: tuple[float, float] = (1, 2)

    # second-order blur kernel synthesis
    blur_kernel_size2: int = 12
    kernel_list2: list[str] = field(default_factory=_default_kernel_list)
    kernel_prob2: list[float] = field(default_factory=_default_kernel_prob)
    kernel_range2: tuple[int, int] = (5, 17)
    sinc_prob2: float = 0
    blur_sigma2: tuple[float, float] = (0.2, 1)
    betag_range2: tuple[float, float] = (0.5, 4)
    betap_range2: tuple[float, float] = (1, 2)

    final_sinc_prob: float = 0
    final_kernel_range: tuple[int, int] = (5, 17)


@dataclass
class PathOptions:
    experiments_root: str | None = None
    models: str | None = None
    resume_models: str | None = None
    training_states: str | None = None
    log: str | None = None
    visualization: str | None = None
    results_root: str | None = None

    pretrain_network_g: str | None = None
    pretrain_network_g_path: str | None = None
    pretrain_network_ae_path: str | None = None
    param_key_g: str | None = None
    strict_load_g: bool = True
    resume_state: str | None = None
    pretrain_network_g_ema: str | None = None

    pretrain_network_d: str | None = None
    param_key_d: str | None = None
    strict_load_d: bool = True
    pretrain_network_ae: str | None = None
    pretrain_network_ae_ema: str | None = None
    pretrain_network_ae_decoder: str | None = None
    pretrain_network_ae_decoder_ema: str | None = None
    ignore_resume_networks: list[str] | None = None


@dataclass
class OnnxOptions:
    dynamo: bool = False
    opset: int = 20
    shape: str = "1x3xHxW"
    verify: bool = True
    dtype: Literal["fp32", "fp16", "bf16"] = "fp16"
    bf16_exclude_depthwise: bool = True
    optimize: bool = True


def _default_moa_augs() -> list[str]:
    return ["none", "mixup", "cutmix", "resizemix"]


def _default_moa_probs() -> list[float]:
    return [0.4, 0.084, 0.084, 0.084, 0.348]


@dataclass
class TrainOptions:
    total_iter: int
    adaptive_d: bool = False
    adaptive_d_ema_decay: float = 0.999
    adaptive_d_threshold: float = 1.02
    optim_g: dict[str, Any] | None = None
    ema_decay: float = 0
    ema_switch_iter: float = 0
    ema_update_after_step: int = 0
    ema_power: float = 10
    grad_clip: bool = False
    warmup_iter: int = -1
    # >0: refresh BatchNormNoStats running statistics over this many train
    # batches at end of training (utils/bn_recalibrate.py) — the functional
    # replacement for torch BatchNorm's side-effect updates; no-op for
    # BN-free archs
    bn_recalibrate_batches: int = 0
    scheduler: dict[str, Any] | None = None
    optim_d: dict[str, Any] | None = None
    optim_ae: dict[str, Any] | None = None

    # new losses format
    losses: list[dict[str, Any]] | None = None

    # legacy (BasicSR-style) per-loss option blocks, still accepted
    pixel_opt: dict[str, Any] | None = None
    mssim_opt: dict[str, Any] | None = None
    ms_ssim_l1_opt: dict[str, Any] | None = None
    perceptual_opt: dict[str, Any] | None = None
    contextual_opt: dict[str, Any] | None = None
    dists_opt: dict[str, Any] | None = None
    hr_inversion_opt: dict[str, Any] | None = None
    dinov2_opt: dict[str, Any] | None = None
    topiq_opt: dict[str, Any] | None = None
    pd_opt: dict[str, Any] | None = None
    fd_opt: dict[str, Any] | None = None
    ldl_opt: dict[str, Any] | None = None
    hsluv_opt: dict[str, Any] | None = None
    gan_opt: dict[str, Any] | None = None
    color_opt: dict[str, Any] | None = None
    luma_opt: dict[str, Any] | None = None
    avg_opt: dict[str, Any] | None = None
    bicubic_opt: dict[str, Any] | None = None

    use_moa: bool = False
    moa_augs: list[str] = field(default_factory=_default_moa_augs)
    moa_probs: list[float] = field(default_factory=_default_moa_probs)
    moa_debug: bool = False
    moa_debug_limit: int = 100

    dynamic_loss_scheduling: dict[str, Any] | None = None
    training_automations: dict[str, Any] | None = None


@dataclass
class ValOptions:
    val_enabled: bool
    save_img: bool
    tile_size: int = 0
    tile_overlap: int = 0
    val_freq: int | None = None
    suffix: str | None = None
    # TPU extra: shard each val image's H axis over the mesh data axis with
    # ppermute halo exchange (parallel/spatial.py) instead of replicating the
    # forward — the multi-chip path for large single images (conv families;
    # halo must cover the receptive-field radius in input pixels)
    spatial_shard: bool = False
    spatial_halo: int = 32

    metrics_enabled: bool = False
    metrics: dict[str, Any] | None = None
    pbar: bool = True


@dataclass
class LogOptions:
    print_freq: int
    save_checkpoint_freq: int
    use_tb_logger: bool
    save_checkpoint_format: Literal["safetensors", "pth"] = "safetensors"
    wandb: WandbOptions | None = None


def _default_resize_prob() -> list[float]:
    return [0.2, 0.7, 0.1]


def _default_resize_prob2() -> list[float]:
    return [0.3, 0.4, 0.3]


def _default_resize_mode_list() -> list[str]:
    return ["bilinear", "bicubic", "nearest-exact", "lanczos"]


def _default_resize_mode_prob() -> list[float]:
    return [0.25, 0.25, 0.25, 0.25]


def _default_compression_formats() -> list[str]:
    return ["jpeg", "webp", "avif", "heif"]


def _default_compression_weights() -> list[float]:
    return [0.60, 0.25, 0.10, 0.05]


def _default_recompression_weights() -> list[float]:
    return [0.50, 0.35, 0.10, 0.05]


def _default_dist_params() -> dict[str, Any]:
    return {"backend": "nccl", "port": 29500}


@dataclass
class ReduxOptions:
    name: str
    scale: int
    num_gpu: Literal["auto"] | int
    path: PathOptions

    input_pixel_format: PixelFormat = "rgb"
    output_pixel_format: PixelFormat = "rgb"

    network_g: dict[str, Any] | None = None
    network_d: dict[str, Any] | None = None
    network_ae: dict[str, Any] | None = None

    manual_seed: int | None = None
    deterministic: bool = False
    dist: bool | None = None
    launcher: str | None = None
    rank: int | None = None
    world_size: int | None = None
    auto_resume: bool | None = None
    watch: bool = False
    start_iter: int = 0
    is_train: bool | None = None
    root_path: str | None = None
    switch_iter_per_epoch: int = 1

    use_amp: bool = False
    amp_bf16: bool = False
    use_channels_last: bool = True
    fast_matmul: bool = False
    use_compile: bool = False
    compile_mode: Literal[
        "default", "reduce-overhead", "max-autotune", "max-autotune-no-cudagraphs"
    ] = "max-autotune-no-cudagraphs"
    detect_anomaly: bool = False

    high_order_degradation: bool = False
    high_order_degradations_debug: bool = False
    high_order_degradations_debug_limit: int = 100
    p_clean: float = 0

    webp_prob: float = 0
    webp_range: tuple[float, float] = (75, 95)
    avif_prob: float = 0
    avif_range: tuple[float, float] = (75, 95)

    oversharpen_prob: float = 0
    oversharpen_strength: tuple[float, float] = (1.0, 2.0)

    chromatic_aberration_prob: float = 0
    demosaic_prob: float = 0
    aliasing_prob: float = 0
    aliasing_scale_range: tuple[float, float] = (0.6, 0.9)

    motion_blur_prob: float = 0
    motion_blur_kernel_size: tuple[int, int] = (5, 15)
    motion_blur_angle_range: tuple[float, float] = (0, 360)

    lens_distort_prob: float = 0
    lens_distort_strength_range: tuple[float, float] = (-0.3, 0.3)

    exposure_prob: float = 0
    exposure_factor_range: tuple[float, float] = (0.5, 2.0)

    color_temp_prob: float = 0
    color_temp_shift_range: tuple[float, float] = (-0.2, 0.2)

    sensor_noise_prob: float = 0
    sensor_noise_std_range: tuple[float, float] = (0.01, 0.1)

    rolling_shutter_prob: float = 0
    rolling_shutter_strength_range: tuple[float, float] = (-0.1, 0.1)

    heif_prob: float = 0
    heif_range: tuple[float, float] = (75, 95)

    enable_sequences: bool = False
    editing_prob: float = 0
    editing_exposure_prob: float = 0
    editing_exposure_range: tuple[float, float] = (0.9, 1.1)
    editing_oversharpen_prob: float = 0
    editing_oversharpen_strength: tuple[float, float] = (1.0, 1.3)
    sequence_probability: float = 0.5
    predefined_sequences: dict[str, Any] = field(default_factory=dict)
    # which named chain sets feed the SequenceController: photo (reference
    # paragon_sequences.py), video (paragon_video_sequences.py),
    # comprehensive (paragon_comprehensive_sequences.py), or all
    sequence_set: str = "photo"

    dataroot_lq_prob: float = 0

    lq_usm: bool = False
    lq_usm_radius_range: tuple[int, int] = (1, 25)

    blur_prob: float = 0
    thicklines_prob: float = 0
    resize_prob: list[float] = field(default_factory=_default_resize_prob)
    resize_mode_list: list[str] = field(default_factory=_default_resize_mode_list)
    resize_mode_prob: list[float] = field(default_factory=_default_resize_mode_prob)
    resize_range: tuple[float, float] = (0.4, 1.5)
    gaussian_noise_prob: float = 0
    noise_range: tuple[float, float] = (0, 0)
    poisson_scale_range: tuple[float, float] = (0, 0)
    gray_noise_prob: float = 0
    jpeg_prob: float = 1
    jpeg_range: tuple[float, float] = (75, 95)

    blur_prob2: float = 0
    resize_prob2: list[float] = field(default_factory=_default_resize_prob2)
    resize_mode_list2: list[str] = field(default_factory=_default_resize_mode_list)
    resize_mode_prob2: list[float] = field(default_factory=_default_resize_mode_prob)
    resize_range2: tuple[float, float] = (0.6, 1.2)
    gaussian_noise_prob2: float = 0
    noise_range2: tuple[float, float] = (0, 0)
    poisson_scale_range2: tuple[float, float] = (0, 0)
    gray_noise_prob2: float = 0
    jpeg_prob2: float = 1
    jpeg_range2: list[float] = field(default_factory=lambda: [75, 95])

    resize_mode_list3: list[str] = field(default_factory=_default_resize_mode_list)
    resize_mode_prob3: list[float] = field(default_factory=_default_resize_mode_prob)

    compression_formats: list[str] = field(default_factory=_default_compression_formats)
    compression_weights: list[float] = field(default_factory=_default_compression_weights)
    compression_jpeg_range: tuple[float, float] = (45, 95)
    compression_webp_range: tuple[float, float] = (60, 85)
    compression_avif_range: tuple[float, float] = (65, 90)
    compression_heif_range: tuple[float, float] = (70, 90)

    recompression_prob: float = 0
    recompression_formats: list[str] = field(default_factory=_default_compression_formats)
    recompression_weights: list[float] = field(default_factory=_default_recompression_weights)

    queue_size: int = 120
    datasets: dict[str, DatasetOptions] = field(default_factory=dict)
    train: TrainOptions | None = None
    val: ValOptions | None = None
    logger: LogOptions | None = None
    dist_params: dict[str, Any] | None = field(default_factory=_default_dist_params)
    onnx: OnnxOptions | None = None

    auto_vram_management: dict[str, Any] | None = None

    find_unused_parameters: bool = False
    contents: str | None = None

    # ------------------------------------------------------------------
    # TPU-native extensions (all optional; absent from reference configs)
    # ------------------------------------------------------------------
    # Device mesh axes for pjit sharding. Default: pure data parallelism over
    # all addressable devices. {'data': -1} means "all devices on data axis".
    mesh: dict[str, int] | None = None
    # Computation dtype policy: params stay fp32, compute in bf16 on TPU.
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"
    # Donate input buffers of the train step (saves HBM).
    donate_state: bool = True
    # Remat (gradient checkpointing) policy for the generator.
    remat: bool = False
    # Optimizer steps executed per device dispatch: the jitted train step
    # lax.scan's over K micro-iterations, so Python/transfer overhead (one
    # device_put + one dispatch) amortizes K-fold. Loader batches grow to
    # K * batch_size_per_gpu * accum_iter; logs reflect the last step of
    # each block. K=1 is the reference-identical per-step loop.
    steps_per_dispatch: int = 1
