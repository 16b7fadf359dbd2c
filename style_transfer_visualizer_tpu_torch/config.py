"""Configuration schema of the port, as dataclasses.

The sections, field names, defaults and bounds are those of the JAX
package's ``config.py`` for every field the port reads. There is no
kernel-backend field: the device of a tensor decides between a kernel
(CUDA) and its plain version (CPU). Bounds are checked when a section
is built and again by :meth:`StyleTransferConfig.validate`, which the
entry points call, so values set after construction are checked too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import get_args

from style_transfer_visualizer_tpu_torch import config_defaults as d
from style_transfer_visualizer_tpu_torch.constants import (
    VIDEO_QUALITY_MAX,
    VIDEO_QUALITY_MIN,
)
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.type_defs import (
    ColorPreservation,
    DirectionName,
    HistoryDtypeName,
    InitMethod,
    ModelName,
    OptimizerName,
    VideoMode,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

#: Bounds of ``OptimizationConfig.pyramid_levels``.
PYRAMID_LEVELS_MIN = 2
PYRAMID_LEVELS_MAX = 6


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check_choice(name: str, value: str, literal: object) -> None:
    choices = get_args(literal)
    _check(value in choices, f"{name} must be one of {choices}: {value!r}")


@dataclass
class OptimizationConfig:
    """Optimization-loop settings."""

    steps: int = d.DEFAULT_STEPS
    style_w: float = d.DEFAULT_STYLE_WEIGHT
    content_w: float = d.DEFAULT_CONTENT_WEIGHT
    # Total-variation smoothness term on the working image (ops/tv.py).
    tv_w: float = d.DEFAULT_TV_WEIGHT
    # Laplacian detail-preservation term (ops/lap.py): the pooled
    # Laplacian response of the content image, ``lap_pool`` the mean
    # pool before the stencil.
    lap_w: float = d.DEFAULT_LAP_WEIGHT
    lap_pool: int = d.DEFAULT_LAP_POOL
    # "luminance" keeps the content's chrominance in every output;
    # "match" remaps each style onto the content's color statistics
    # before its Gram targets are computed (ops/color.py).
    preserve_color: ColorPreservation = d.DEFAULT_PRESERVE_COLOR
    lr: float = d.DEFAULT_LEARNING_RATE
    init_method: InitMethod = d.DEFAULT_INIT_METHOD
    seed: int = d.DEFAULT_SEED
    normalize: bool = d.DEFAULT_NORMALIZE
    lbfgs_max_iter: int = d.DEFAULT_LBFGS_MAX_ITER
    lbfgs_max_eval: int = d.DEFAULT_LBFGS_MAX_EVAL
    style_layers: list[int] = field(
        default_factory=lambda: list(d.DEFAULT_STYLE_LAYERS),
    )
    content_layers: list[int] = field(
        default_factory=lambda: list(d.DEFAULT_CONTENT_LAYERS),
    )
    lbfgs_history_size: int = d.DEFAULT_LBFGS_HISTORY_SIZE
    lbfgs_history_dtype: HistoryDtypeName = d.DEFAULT_LBFGS_HISTORY_DTYPE
    lbfgs_direction: DirectionName = d.DEFAULT_LBFGS_DIRECTION
    # One weight per entry of ``style_layers`` on that layer's Gram
    # MSE; None weighs every layer 1.0.
    style_layer_weights: list[float] | None = None
    model: ModelName = d.DEFAULT_MODEL
    optimizer: OptimizerName = d.DEFAULT_OPTIMIZER
    # Coarse-to-fine warm start (engine/coarse.py): -1 auto (on for
    # content of at least 1 MP with a steps // 5 budget), 0 off, N > 0
    # that many steps split over ``pyramid_levels - 1`` coarse levels.
    coarse_steps: int = d.DEFAULT_COARSE_STEPS
    pyramid_levels: int = d.DEFAULT_PYRAMID_LEVELS
    # Permit seeded-random VGG weights when no converted weights
    # archive is found; stylization quality will be poor.
    allow_random_weights: bool = False

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` on a value outside its bounds.

        Also moves layer lists left at the VGG19 defaults onto another
        model's own taps, before the style weights are checked against
        ``style_layers``.
        """
        _check(self.steps >= 1, "steps must be >= 1")
        _check(self.style_w >= 0, "style_w must be >= 0")
        _check(self.content_w >= 0, "content_w must be >= 0")
        _check(self.tv_w >= 0, "tv_w must be >= 0")
        _check(self.lap_w >= 0, "lap_w must be >= 0")
        _check(self.lap_pool >= 1, "lap_pool must be >= 1")
        _check(self.lr > 0, "lr must be > 0")
        _check(self.coarse_steps >= -1, "coarse_steps must be >= -1")
        _check(
            PYRAMID_LEVELS_MIN <= self.pyramid_levels <= PYRAMID_LEVELS_MAX,
            f"pyramid_levels must be in [{PYRAMID_LEVELS_MIN}, "
            f"{PYRAMID_LEVELS_MAX}]",
        )
        _check(self.seed >= 0, "seed must be >= 0")
        _check(self.lbfgs_max_iter >= 1, "lbfgs_max_iter must be >= 1")
        _check(self.lbfgs_max_eval >= 1, "lbfgs_max_eval must be >= 1")
        _check(
            self.lbfgs_history_size >= 1, "lbfgs_history_size must be >= 1",
        )
        _check_choice("init_method", self.init_method, InitMethod)
        _check_choice(
            "lbfgs_history_dtype", self.lbfgs_history_dtype,
            HistoryDtypeName,
        )
        _check_choice(
            "lbfgs_direction", self.lbfgs_direction, DirectionName,
        )
        _check_choice(
            "preserve_color", self.preserve_color, ColorPreservation,
        )
        _check_choice("model", self.model, ModelName)
        _check_choice("optimizer", self.optimizer, OptimizerName)
        self._remap_default_layers_for_model()
        self._check_style_layer_weights()

    def _remap_default_layers_for_model(self) -> None:
        """Move VGG19-default layer lists onto the selected model's taps.

        Layer indices address torchvision's flat ``features``
        numbering, which differs per architecture: lists still at the
        VGG19 defaults mean the user chose none, so the model's own
        standard taps (the same named layers) apply. Lists chosen
        explicitly are never touched.
        """
        if self.model == "vgg19":
            return
        arch = get_architecture(self.model)
        changed = False
        if tuple(self.style_layers) == d.DEFAULT_STYLE_LAYERS:
            self.style_layers = list(arch.default_style_layers)
            changed = True
        if tuple(self.content_layers) == d.DEFAULT_CONTENT_LAYERS:
            self.content_layers = list(arch.default_content_layers)
            changed = True
        if changed:
            logger.info(
                "Model %s: layer defaults remapped to style=%s content=%s",
                self.model, self.style_layers, self.content_layers,
            )

    def _check_style_layer_weights(self) -> None:
        """One non-negative weight per style layer, not all zero."""
        weights = self.style_layer_weights
        if weights is None:
            return
        _check(
            len(weights) == len(self.style_layers),
            f"style_layer_weights has {len(weights)} entries for "
            f"{len(self.style_layers)} style layers",
        )
        _check(
            all(w >= 0 for w in weights),
            "style_layer_weights entries must be >= 0",
        )
        _check(
            not weights or any(w > 0 for w in weights),
            "style_layer_weights must include a positive weight",
        )

    def style_weights_tuple(self) -> tuple[float, ...] | None:
        """``style_layer_weights`` as the step builder's tuple form."""
        if self.style_layer_weights is None:
            return None
        return tuple(float(w) for w in self.style_layer_weights)


@dataclass
class HardwareConfig:
    """Device selection, checked by ``runtime.device.setup_device``.

    There is no precision field yet: both kernels compute 3xTF32 on the
    tensor cores (each fp32 operand split into tf32 hi and lo halves,
    three products), about 21 mantissa bits, at every setting.
    """

    device: str = d.DEFAULT_DEVICE


@dataclass
class VideoConfig:
    """Timelapse video/GIF output settings."""

    save_every: int = d.DEFAULT_SAVE_EVERY
    fps: int = d.DEFAULT_FPS
    quality: int = d.DEFAULT_VIDEO_QUALITY
    create_video: bool = d.DEFAULT_CREATE_VIDEO
    final_only: bool = d.DEFAULT_FINAL_ONLY
    intro_enabled: bool = d.DEFAULT_VIDEO_INTRO_ENABLED
    intro_duration_seconds: float = d.DEFAULT_VIDEO_INTRO_DURATION
    metadata_title: str | None = None
    metadata_artist: str | None = None
    final_frame_compare: bool = d.DEFAULT_VIDEO_FINAL_FRAME_COMPARE
    outro_duration_seconds: float = d.DEFAULT_VIDEO_OUTRO_DURATION
    mode: VideoMode = d.DEFAULT_VIDEO_MODE
    create_gif: bool = d.DEFAULT_CREATE_GIF
    gif_include_intro: bool = d.DEFAULT_GIF_INCLUDE_INTRO
    gif_include_outro: bool = d.DEFAULT_GIF_INCLUDE_OUTRO
    # Set when the user picked the mode explicitly, which disables the
    # auto realtime->postprocess promotion heuristic.
    mode_override: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` on a value outside its bounds."""
        _check(self.save_every >= 1, "save_every must be >= 1")
        _check(1 <= self.fps <= 60, "fps must be in [1, 60]")  # noqa: PLR2004
        _check(
            VIDEO_QUALITY_MIN <= self.quality <= VIDEO_QUALITY_MAX,
            f"quality must be in [{VIDEO_QUALITY_MIN}, "
            f"{VIDEO_QUALITY_MAX}]",
        )
        _check(
            self.intro_duration_seconds >= 0,
            "intro_duration_seconds must be >= 0",
        )
        _check(
            self.outro_duration_seconds >= 0,
            "outro_duration_seconds must be >= 0",
        )
        _check_choice("mode", self.mode, VideoMode)


@dataclass
class OutputConfig:
    """Output directory, loss-logging cadence, CSV and plot."""

    output: str = d.DEFAULT_OUTPUT_DIR
    log_every: int = d.DEFAULT_LOG_EVERY
    log_loss: str | None = None
    plot_losses: bool = True

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` on a non-positive cadence."""
        _check(self.log_every >= 1, "log_every must be >= 1")


@dataclass
class StyleTransferConfig:
    """Root config grouping the sections the port reads."""

    output: OutputConfig = field(default_factory=OutputConfig)
    optimization: OptimizationConfig = field(
        default_factory=OptimizationConfig,
    )
    video: VideoConfig = field(default_factory=VideoConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)

    def validate(self) -> None:
        """Check every section's bounds."""
        self.output.validate()
        self.optimization.validate()
        self.video.validate()
