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
from style_transfer_visualizer_tpu_torch.type_defs import (
    DirectionName,
    HistoryDtypeName,
    InitMethod,
)


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
    # Permit seeded-random VGG19 weights when no converted weights
    # archive is found; stylization quality will be poor.
    allow_random_weights: bool = False

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` on a value outside its bounds."""
        _check(self.steps >= 1, "steps must be >= 1")
        _check(self.style_w >= 0, "style_w must be >= 0")
        _check(self.content_w >= 0, "content_w must be >= 0")
        _check(self.lr > 0, "lr must be > 0")
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


@dataclass
class HardwareConfig:
    """Device selection, checked by ``runtime.device.setup_device``.

    There is no precision field yet: both kernels compute IEEE fp32.
    """

    device: str = d.DEFAULT_DEVICE


@dataclass
class OutputConfig:
    """Output directory and loss-logging cadence."""

    output: str = d.DEFAULT_OUTPUT_DIR
    log_every: int = d.DEFAULT_LOG_EVERY

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
    hardware: HardwareConfig = field(default_factory=HardwareConfig)

    def validate(self) -> None:
        """Check every section's bounds."""
        self.output.validate()
        self.optimization.validate()
