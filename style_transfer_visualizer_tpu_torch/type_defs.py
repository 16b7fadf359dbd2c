"""Type aliases and small data carriers of the port.

The names match the JAX package's ``type_defs.py``; tensors stand in
for ``jax.Array``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

if TYPE_CHECKING:
    import torch

#: Starting-image strategies for the pixel optimization.
InitMethod = Literal["content", "random", "white"]

#: Pixel optimizers of the engine.
OptimizerName = Literal["lbfgs", "adam"]

#: VGG-family feature backbones.
ModelName = Literal["vgg19", "vgg16"]

#: Color-preservation schemes (Gatys et al. 2016): "luminance"
#: recombines stylized luminance with content chrominance on every
#: output; "match" remaps the style image onto the content's color
#: statistics before targets are computed.
ColorPreservation = Literal["off", "luminance", "match"]

#: Matmul-precision tiers (``ops/precision.py``): IEEE fp32, the mixed
#: policy, 3xTF32, TF32 on the card.
PrecisionName = Literal["highest", "mixed", "high", "default"]

#: Storage type of the L-BFGS curvature ring.
HistoryDtypeName = Literal["float32", "bfloat16"]

#: L-BFGS direction computation.
DirectionName = Literal["two-loop", "compact"]

#: Gallery-wall arrangements rendered by the compositing subsystem.
LayoutName = Literal["gallery-stacked-left", "gallery-two-across"]

#: Encoding strategy: stream frames live, or spill and encode at the end.
VideoMode = Literal["realtime", "postprocess"]

#: Loss-series mapping produced by the runner for plotting.
LossHistory = dict[str, list[float]]


@dataclass(slots=True)
class InputPaths:
    """The two input image locations for a run."""

    #: Path to the content image file.
    content_path: str
    #: Path to the style image file.
    style_path: str


@dataclass(slots=True)
class SaveOptions:
    """Everything the final persistence step needs to know."""

    #: Stem of the content image (drives canonical output names).
    content_name: str
    #: Stem of the style image.
    style_name: str
    #: Timelapse MP4 filename, when a video sink was active.
    video_name: str | None = None
    #: GIF filename, when GIF export was active.
    gif_name: str | None = None
    #: Whether the working image is in ImageNet-normalized space.
    normalize: bool = True
    #: Whether an MP4 was produced (controls the saved-video log line).
    video_created: bool = True
    #: Whether a GIF was produced.
    gif_created: bool = False
    #: Whether to render the matplotlib loss plot.
    plot_losses: bool = True
    #: Content image in [0,1] RGB for luminance-only color
    #: preservation of the final PNG; None leaves colors untouched.
    chroma_source: torch.Tensor | None = None
    #: File name of the final PNG in place of the canonical
    #: ``stylized_{content}_x_{style}.png``.
    final_name: str | None = None
