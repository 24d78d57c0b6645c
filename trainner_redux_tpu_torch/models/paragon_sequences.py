"""Degradation sequence control (Paragon; port of the JAX package's
models/paragon_sequences.py, pure numpy, kept as its own copy).

Named sequences of degradation steps with per-step probabilities and
parameter ranges, a controller that picks one sequence per batch, and the
predefined chains (photo, video, comprehensive). Selection happens on the
host per iteration from an explicit numpy Generator, in the JAX package's
order, so the same seed gives the same plans; RealESRGANModel runs each
plan's steps through ops/degradations.py on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class DegradationStep:
    degradation_type: str
    probability: float = 1.0
    parameters: dict[str, Any] = field(default_factory=dict)
    probability_range: tuple[float, float] | None = None
    parameter_ranges: dict[str, tuple[float, float]] = field(default_factory=dict)

    def should_apply(self, rng: np.random.Generator) -> bool:
        prob = (
            rng.uniform(*self.probability_range)
            if self.probability_range
            else self.probability
        )
        return rng.uniform() < prob

    def sample_parameters(self, rng: np.random.Generator) -> dict[str, Any]:
        params = dict(self.parameters)
        for name, rng_range in self.parameter_ranges.items():
            if name not in params:
                params[name] = float(rng.uniform(rng_range[0], rng_range[1]))
        return params


@dataclass
class DegradationSequence:
    name: str
    probability: float
    steps: list[DegradationStep]
    repeat: int = 1
    repeat_probability: float = 0.0

    def get_repeat_count(self, rng: np.random.Generator) -> int:
        count = self.repeat
        while rng.uniform() < self.repeat_probability:
            count += 1
        return count


class SequenceController:
    """Selects a sequence per iteration and emits an executable plan."""

    def __init__(self, sequences: list[DegradationSequence], seed: int = 0) -> None:
        self.sequences = list(sequences)
        self.rng = np.random.default_rng([seed, 900001])

    def select_sequence(self) -> DegradationSequence | None:
        if not self.sequences:
            return None
        probs = np.asarray([s.probability for s in self.sequences], np.float64)
        total = probs.sum()
        if total <= 0:
            return None
        if self.rng.uniform() > min(total, 1.0):
            return None
        probs = probs / total
        idx = int(self.rng.choice(len(self.sequences), p=probs))
        return self.sequences[idx]

    def plan(self) -> list[tuple[str, dict[str, Any]]]:
        """One iteration's degradation plan: [(op_name, params), ...]."""
        seq = self.select_sequence()
        if seq is None:
            return []
        steps: list[tuple[str, dict[str, Any]]] = []
        for _ in range(seq.get_repeat_count(self.rng)):
            for step in seq.steps:
                if step.should_apply(self.rng):
                    steps.append((step.degradation_type, step.sample_parameters(self.rng)))
        return steps


def create_predefined_sequences() -> list[DegradationSequence]:
    """The four photo chains of upstream traiNNer's paragon_sequences.py,
    with its names, step orders, probabilities and parameter ranges."""
    return [
        DegradationSequence(
            "internet_upload_download",
            0.25,
            [
                DegradationStep("oversharpening", probability_range=(0.6, 0.9),
                                parameter_ranges={"strength": (1.1, 1.8)}),
                DegradationStep("color_temp_shift", probability_range=(0.3, 0.7),
                                parameter_ranges={"shift": (-0.15, 0.15)}),
                DegradationStep("lens_distortion", probability_range=(0.2, 0.5),
                                parameter_ranges={"strength": (-0.1, 0.1)}),
                DegradationStep("webp_compression", 1.0,
                                parameter_ranges={"quality": (60, 85)}),
                DegradationStep("avif_compression", probability_range=(0.1, 0.3),
                                parameter_ranges={"quality": (65, 90)}),
                DegradationStep("jpeg_compression", probability_range=(0.2, 0.4),
                                parameter_ranges={"quality": (70, 90)}),
                DegradationStep("oversharpening", probability_range=(0.4, 0.8),
                                parameter_ranges={"strength": (1.05, 1.4)}),
            ],
            repeat=1,
            repeat_probability=0.3,
        ),
        DegradationSequence(
            "phone_camera_capture",
            0.3,
            [
                DegradationStep("sensor_noise", probability_range=(0.8, 1.0),
                                parameter_ranges={"std": (0.02, 0.08)}),
                DegradationStep("rolling_shutter", probability_range=(0.3, 0.7),
                                parameter_ranges={"strength": (0.02, 0.08)}),
                DegradationStep("lens_distortion", probability_range=(0.6, 0.9),
                                parameter_ranges={"strength": (0.1, 0.3)}),
                DegradationStep("motion_blur", probability_range=(0.2, 0.5),
                                parameter_ranges={"kernel_size": (3, 7),
                                                  "angle": (0, 360)}),
                DegradationStep("chromatic_aberration",
                                probability_range=(0.4, 0.8),
                                parameter_ranges={"strength": (0.5, 2.0)}),
                DegradationStep("oversharpening", probability_range=(0.7, 0.9),
                                parameter_ranges={"strength": (1.1, 1.5)}),
                DegradationStep("heif_compression", probability_range=(0.8, 1.0),
                                parameter_ranges={"quality": (75, 95)}),
            ],
        ),
        DegradationSequence(
            "dslr_professional",
            0.2,
            [
                DegradationStep("sensor_noise", probability_range=(0.3, 0.6),
                                parameter_ranges={"std": (0.005, 0.03)}),
                DegradationStep("rolling_shutter", probability_range=(0.1, 0.3),
                                parameter_ranges={"strength": (0.005, 0.02)}),
                DegradationStep("lens_distortion", probability_range=(0.4, 0.7),
                                parameter_ranges={"strength": (0.02, 0.1)}),
                DegradationStep("oversharpening", probability_range=(0.5, 0.8),
                                parameter_ranges={"strength": (1.05, 1.3)}),
                DegradationStep("color_temp_shift", probability_range=(0.4, 0.7),
                                parameter_ranges={"shift": (-0.1, 0.1)}),
                DegradationStep("jpeg_compression", probability_range=(0.8, 1.0),
                                parameter_ranges={"quality": (85, 98)}),
            ],
        ),
        DegradationSequence(
            "social_media_upload",
            0.25,
            [
                DegradationStep("oversharpening", probability_range=(0.7, 0.95),
                                parameter_ranges={"strength": (1.2, 2.0)}),
                DegradationStep("lens_distortion", probability_range=(0.3, 0.6),
                                parameter_ranges={"strength": (-0.05, 0.05)}),
                DegradationStep("webp_compression", probability_range=(0.9, 1.0),
                                parameter_ranges={"quality": (50, 80)}),
                DegradationStep("jpeg_compression", probability_range=(0.4, 0.7),
                                parameter_ranges={"quality": (60, 85)}),
                DegradationStep("oversharpening", probability_range=(0.6, 0.9),
                                parameter_ranges={"strength": (1.1, 1.6)}),
            ],
            repeat=1,
            repeat_probability=0.4,
        ),
    ]


def create_video_sequences() -> list[DegradationSequence]:
    """The five platform video chains of upstream paragon_video_sequences.py:
    codec artifacts run through the device surrogates of ops/degradations.py
    (apply_video_codec_artifacts, block artifacts, banding, ringing)."""
    return [
        DegradationSequence(
            "youtube_video",
            0.15,
            [
                DegradationStep("oversharpening", probability_range=(0.7, 0.9),
                                parameter_ranges={"strength": (1.1, 1.5)}),
                DegradationStep("color_temp_shift", probability_range=(0.4, 0.7),
                                parameter_ranges={"shift": (-0.1, 0.1)}),
                DegradationStep("video_compression", 1.0,
                                parameter_ranges={"crf": (23, 35)}),
                DegradationStep("block_artifacts", probability_range=(0.5, 0.8),
                                parameter_ranges={"strength": (8, 16)}),
                DegradationStep("color_banding", probability_range=(0.4, 0.7),
                                parameter_ranges={"bits": (6, 8)}),
                DegradationStep("ringing", probability_range=(0.3, 0.6),
                                parameter_ranges={"strength": (0.02, 0.08)}),
                DegradationStep("oversharpening", probability_range=(0.6, 0.9),
                                parameter_ranges={"strength": (1.05, 1.3)}),
            ],
        ),
        DegradationSequence(
            "tiktok_shortform",
            0.15,
            [
                DegradationStep("exposure_error", probability_range=(0.7, 0.95),
                                parameter_ranges={"factor": (0.85, 1.4)}),
                DegradationStep("color_temp_shift", probability_range=(0.8, 0.95),
                                parameter_ranges={"shift": (-0.25, 0.25)}),
                DegradationStep("oversharpening", probability_range=(0.85, 0.98),
                                parameter_ranges={"strength": (1.3, 2.5)}),
                DegradationStep("video_compression", 1.0,
                                parameter_ranges={"crf": (28, 40)}),
                DegradationStep("block_artifacts", probability_range=(0.7, 0.95),
                                parameter_ranges={"strength": (12, 24)}),
                DegradationStep("color_banding", probability_range=(0.6, 0.85),
                                parameter_ranges={"bits": (5, 7)}),
            ],
            repeat=1,
            repeat_probability=0.5,
        ),
        DegradationSequence(
            "streaming_service",
            0.1,
            [
                DegradationStep("video_compression", 1.0,
                                parameter_ranges={"crf": (20, 30)}),
                DegradationStep("block_artifacts", probability_range=(0.3, 0.6),
                                parameter_ranges={"strength": (6, 12)}),
                DegradationStep("ringing", probability_range=(0.2, 0.5),
                                parameter_ranges={"strength": (0.02, 0.06)}),
            ],
        ),
        DegradationSequence(
            "social_multi_platform",
            0.1,
            [
                DegradationStep("oversharpening", probability_range=(0.6, 0.9),
                                parameter_ranges={"strength": (1.2, 1.8)}),
                DegradationStep("video_compression", 1.0,
                                parameter_ranges={"crf": (26, 38)}),
                DegradationStep("video_compression", probability_range=(0.5, 0.8),
                                parameter_ranges={"crf": (30, 42)}),
                DegradationStep("color_banding", probability_range=(0.5, 0.8),
                                parameter_ranges={"bits": (5, 7)}),
            ],
            repeat=1,
            repeat_probability=0.4,
        ),
        DegradationSequence(
            "dvdrip_anime",
            0.1,
            [
                DegradationStep("blur", probability_range=(0.4, 0.7),
                                parameter_ranges={"sigma": (0.4, 1.2)}),
                DegradationStep("video_compression", 1.0,
                                parameter_ranges={"crf": (24, 36)}),
                DegradationStep("ringing", probability_range=(0.5, 0.8),
                                parameter_ranges={"strength": (0.04, 0.1)}),
                DegradationStep("color_banding", probability_range=(0.4, 0.7),
                                parameter_ranges={"bits": (6, 8)}),
            ],
        ),
    ]


def create_comprehensive_sequences() -> list[DegradationSequence]:
    """The four end-to-end lifecycle chains of upstream
    paragon_comprehensive_sequences.py."""
    return [
        DegradationSequence(
            "professional_to_internet",
            0.25,
            [
                DegradationStep("sensor_noise", probability_range=(0.3, 0.6),
                                parameter_ranges={"std": (0.005, 0.02)}),
                DegradationStep("lens_distortion", probability_range=(0.3, 0.6),
                                parameter_ranges={"strength": (0.02, 0.08)}),
                DegradationStep("oversharpening", probability_range=(0.5, 0.8),
                                parameter_ranges={"strength": (1.05, 1.3)}),
                DegradationStep("jpeg_compression", 1.0,
                                parameter_ranges={"quality": (85, 96)}),
                DegradationStep("webp_compression", probability_range=(0.6, 0.9),
                                parameter_ranges={"quality": (60, 85)}),
                DegradationStep("oversharpening", probability_range=(0.4, 0.7),
                                parameter_ranges={"strength": (1.05, 1.35)}),
            ],
        ),
        DegradationSequence(
            "phone_to_social",
            0.3,
            [
                DegradationStep("sensor_noise", probability_range=(0.7, 0.95),
                                parameter_ranges={"std": (0.02, 0.07)}),
                DegradationStep("lens_distortion", probability_range=(0.5, 0.8),
                                parameter_ranges={"strength": (0.08, 0.25)}),
                DegradationStep("oversharpening", probability_range=(0.7, 0.95),
                                parameter_ranges={"strength": (1.2, 1.9)}),
                DegradationStep("exposure_error", probability_range=(0.4, 0.7),
                                parameter_ranges={"factor": (0.85, 1.3)}),
                DegradationStep("heif_compression", probability_range=(0.7, 0.95),
                                parameter_ranges={"quality": (70, 92)}),
                DegradationStep("webp_compression", 1.0,
                                parameter_ranges={"quality": (50, 78)}),
            ],
            repeat=1,
            repeat_probability=0.35,
        ),
        DegradationSequence(
            "social_processing",
            0.25,
            [
                DegradationStep("exposure_error", probability_range=(0.5, 0.8),
                                parameter_ranges={"factor": (0.9, 1.25)}),
                DegradationStep("color_temp_shift", probability_range=(0.5, 0.8),
                                parameter_ranges={"shift": (-0.2, 0.2)}),
                DegradationStep("oversharpening", probability_range=(0.7, 0.95),
                                parameter_ranges={"strength": (1.2, 2.2)}),
                DegradationStep("webp_compression", 1.0,
                                parameter_ranges={"quality": (45, 75)}),
                DegradationStep("jpeg_compression", probability_range=(0.4, 0.7),
                                parameter_ranges={"quality": (55, 80)}),
            ],
            repeat=1,
            repeat_probability=0.4,
        ),
        DegradationSequence(
            "legacy_internet",
            0.2,
            [
                DegradationStep("blur", probability_range=(0.4, 0.7),
                                parameter_ranges={"sigma": (0.5, 1.5)}),
                DegradationStep("jpeg_compression", 1.0,
                                parameter_ranges={"quality": (35, 65)}),
                DegradationStep("color_banding", probability_range=(0.3, 0.6),
                                parameter_ranges={"bits": (5, 7)}),
                DegradationStep("jpeg_compression", probability_range=(0.5, 0.8),
                                parameter_ranges={"quality": (30, 60)}),
            ],
            repeat=1,
            repeat_probability=0.3,
        ),
    ]


def sequences_for_set(name: str) -> list[DegradationSequence]:
    """Resolve the `sequence_set` config value to chain lists."""
    sets = {
        "photo": create_predefined_sequences,
        "video": create_video_sequences,
        "comprehensive": create_comprehensive_sequences,
    }
    if name == "all":
        return [s for f in sets.values() for s in f()]
    if name not in sets:
        raise ValueError(
            f"unknown sequence_set {name!r}; choose from "
            f"{sorted(sets)} or 'all'"
        )
    return sets[name]()
