"""Type aliases and small data carriers of the port.

The names match the JAX package's ``type_defs.py``; tensors stand in
for ``jax.Array``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

#: Starting-image strategies for the pixel optimization.
InitMethod = Literal["content", "random", "white"]

#: Storage type of the L-BFGS curvature ring.
HistoryDtypeName = Literal["float32", "bfloat16"]

#: L-BFGS direction computation.
DirectionName = Literal["two-loop", "compact"]

#: Loss-series mapping produced by the runner for plotting.
LossHistory = dict[str, list[float]]


@dataclass(slots=True)
class InputPaths:
    """The two input image locations for a run."""

    #: Path to the content image file.
    content_path: str
    #: Path to the style image file.
    style_path: str
