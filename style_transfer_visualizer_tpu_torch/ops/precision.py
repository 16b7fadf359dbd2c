"""Matmul-precision tiers, the mixed policy, and the kernels' modes.

The port of the JAX package's ``ops/precision.py`` and of its
``engine/step.resolve_precision``. A tier names a precision level per
matmul; the port keeps the JAX package's meaning of a level, a count
of passes, and :data:`KERNEL_MODES` maps each level to the mode in
which the two CUDA kernels (``csrc/conv3x3*.cu``, ``csrc/gram.cu``)
run it on the card:

- ``highest`` -> ``ieee``: IEEE fp32 FMA on the CUDA cores;
- ``high`` -> ``tf32x3``: three tf32 products of the hi/lo split on the
  tensor cores, about 21 bits of mantissa;
- ``default`` (and ``None``) -> ``tf32``: one tf32 product on the
  tensor cores, about 11 bits of each operand.

``mixed``, the pipeline default, is :data:`MIXED`, the JAX package's
policy copied literally: the first two VGG blocks' forward convs
(indices 0, 2, 5, 7) and every Gram's forward at ``highest``, every
other conv, every backward conv and the Gram backward at ``high``.

On a CPU tensor every mode runs the plain fp32 version: the tier does
not change the CPU path, as XLA's CPU backend runs every f32 dot in
f32 whatever the precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, TypeAlias

#: A precision level: the JAX package's ``lax.Precision`` by name.
Level: TypeAlias = Literal["highest", "high", "default"]
#: A kernel mode (``csrc/``): what a level computes on the card.
Mode: TypeAlias = Literal["ieee", "tf32x3", "tf32"]

HIGHEST: Level = "highest"
HIGH: Level = "high"
DEFAULT: Level = "default"

#: The one table from a level to the kernels' mode. ``None`` is the
#: JAX package's unset precision, its backend default.
KERNEL_MODES: dict[Level | None, Mode] = {
    HIGHEST: "ieee",
    HIGH: "tf32x3",
    DEFAULT: "tf32",
    None: "tf32",
}
MODES: tuple[Mode, ...] = ("ieee", "tf32x3", "tf32")


def kernel_mode(level: Level | None) -> Mode:
    """The kernels' mode for a precision level."""
    try:
        return KERNEL_MODES[level]
    except KeyError:
        msg = f"Unknown precision level: {level!r}"
        raise ValueError(msg) from None


@dataclass(frozen=True)
class PrecisionPolicy:
    """Per-role precision levels for the VGG feature pipeline.

    ``conv_overrides`` maps torchvision layer indices to a level that
    replaces ``conv_base`` for that conv only; ``gram`` applies to
    every Gram contraction (style-target and loss side alike).
    ``conv_bwd_overrides`` optionally gives the backward (input-
    gradient) convs their own override table: ``None`` mirrors the
    forward, ``()`` runs every backward conv at ``conv_base``. Frozen
    with tuple fields, so instances hash.
    """

    conv_base: Level | None
    conv_overrides: tuple[tuple[int, Level], ...] = ()
    gram: Level | None = None
    conv_bwd_overrides: tuple[tuple[int, Level], ...] | None = None
    gram_bwd: Level | None = None

    def conv(self, layer_idx: int) -> Level | None:
        """Level for the conv at torchvision index ``layer_idx``."""
        for idx, level in self.conv_overrides:
            if idx == layer_idx:
                return level
        return self.conv_base

    def gram_bwd_or_mirror(self) -> Level | None:
        """Backward level of the Gram contractions (mirrors ``gram``
        when unset)."""
        if self.gram_bwd is not None:
            return self.gram_bwd
        return self.gram if self.gram is not None else self.conv_base

    def conv_bwd(self, layer_idx: int) -> Level | None:
        """Level for layer ``layer_idx``'s backward (input-grad) conv."""
        if self.conv_bwd_overrides is None:
            return self.conv(layer_idx)
        for idx, level in self.conv_bwd_overrides:
            if idx == layer_idx:
                return level
        return self.conv_base


#: What every ``precision=`` argument of the port accepts.
PrecisionLike: TypeAlias = "Level | PrecisionPolicy | None"


def conv_precision(precision: PrecisionLike, layer_idx: int) -> Level | None:
    """Level for the conv at ``layer_idx`` under a policy or tier."""
    if isinstance(precision, PrecisionPolicy):
        return precision.conv(layer_idx)
    return precision


def conv_bwd_precision(
    precision: PrecisionLike, layer_idx: int,
) -> Level | None:
    """Level for the backward conv at ``layer_idx``."""
    if isinstance(precision, PrecisionPolicy):
        return precision.conv_bwd(layer_idx)
    return precision


def gram_bwd_precision(precision: PrecisionLike) -> Level | None:
    """Level for the backward of a Gram contraction."""
    if isinstance(precision, PrecisionPolicy):
        return precision.gram_bwd_or_mirror()
    return precision


def gram_precision(precision: PrecisionLike) -> Level | None:
    """Level for Gram contractions under a policy or tier."""
    if isinstance(precision, PrecisionPolicy):
        return precision.gram if precision.gram is not None \
            else precision.conv_base
    return precision


#: The pipeline-default tier. Indices 0/2/5/7 are conv1_1, conv1_2,
#: conv2_1, conv2_2 in torchvision's numbering, the first two blocks of
#: every VGG configuration (vgg16 included). Backward convs and the
#: Gram backward run at ``high`` (``conv_bwd_overrides=()``).
MIXED = PrecisionPolicy(
    conv_base=HIGH,
    conv_overrides=(
        (0, HIGHEST),
        (2, HIGHEST),
        (5, HIGHEST),
        (7, HIGHEST),
    ),
    gram=HIGHEST,
    conv_bwd_overrides=(),
    gram_bwd=HIGH,
)

_PRECISIONS: dict[str, PrecisionLike] = {
    "highest": HIGHEST,
    "mixed": MIXED,
    "high": HIGH,
    "default": DEFAULT,
}
#: The config's precision names, in the JAX CLI's order.
PRECISION_NAMES: tuple[str, ...] = tuple(_PRECISIONS)


def resolve_precision(name: str) -> PrecisionLike:
    """Map a config precision name to a level or the mixed policy.

    "mixed", the pipeline default, resolves to :data:`MIXED`.
    """
    try:
        return _PRECISIONS[name]
    except KeyError:
        msg = f"Unknown precision: {name!r}"
        raise ValueError(msg) from None
