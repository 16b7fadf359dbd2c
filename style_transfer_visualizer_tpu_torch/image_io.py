"""Image loading, device-side preprocessing, and output preparation.

Host side: Pillow decodes to RGB and checks the dimensions. Device side:
scaling to [0,1], ImageNet normalization, denormalization, NaN scrubbing
and uint8 packing run on the tensor's own device. Images are
``(1, H, W, 3)`` NHWC float32, the JAX package's layout.

Pillow is imported only inside the two functions that read or write
files, so the rest of the port runs where Pillow is absent.
"""
from __future__ import annotations

from functools import cache
from typing import TYPE_CHECKING

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch.constants import (
    COLOR_MODE_RGB,
    IMAGENET_MEAN,
    IMAGENET_STD,
    MAX_DIMENSION,
    MIN_DIMENSION,
)
from style_transfer_visualizer_tpu_torch.ops.color import (
    match_color_distribution,
    maybe_restore_color,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from pathlib import Path


def _stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _stats_on(x.dtype, x.device)


@cache
def _stats_on(
    dtype: torch.dtype, device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet statistics on ``device``, made once per device.

    Making them per call would copy from pageable host memory, which
    waits for the device's stream: the timelapse frame path must not.
    """
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=device)
    return mean, std


def validate_image_dimensions(width: int, height: int) -> None:
    """Hard-fail below MIN_DIMENSION; warn above MAX_DIMENSION."""
    if width < MIN_DIMENSION or height < MIN_DIMENSION:
        msg = (
            f"Image too small: {width}x{height}. "
            f"Minimum dimension is {MIN_DIMENSION}px."
        )
        raise ValueError(msg)
    if width > MAX_DIMENSION or height > MAX_DIMENSION:
        logger.warning(
            "Image is large: %dx%d. This may slow processing.",
            width, height,
        )


def load_image_to_host_array(path: str | Path) -> np.ndarray:
    """Decode and validate an image to a (1, H, W, 3) [0,1] host array."""
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    try:
        with Image.open(path) as img:
            rgb = img.convert(COLOR_MODE_RGB)
    except FileNotFoundError as e:
        msg = f"Image file not found: '{path}'"
        raise FileNotFoundError(msg) from e
    except OSError as e:
        msg = f"Error loading image '{path}': {e!s}"
        raise OSError(msg) from e
    validate_image_dimensions(rgb.width, rgb.height)
    return (np.asarray(rgb, dtype=np.float32) / 255.0)[None, ...]


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """Apply ImageNet channel normalization to an NHWC tensor in [0,1]."""
    mean, std = _stats(x)
    return (x - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """Invert ImageNet normalization on an NHWC tensor."""
    mean, std = _stats(x)
    return x * std + mean


def host_array_to_device(
    host: np.ndarray,
    device: torch.device | str,
    *,
    normalize: bool = False,
) -> torch.Tensor:
    """Place a (1, H, W, 3) [0,1] host array on ``device``.

    Normalization (when requested) runs on the device.
    """
    arr = torch.tensor(np.asarray(host, dtype=np.float32), device=device)
    return normalize_image(arr) if normalize else arr


def style_array_to_device(
    host: np.ndarray,
    device: torch.device | str,
    *,
    normalize: bool = False,
    match_to: np.ndarray | None = None,
) -> torch.Tensor:
    """Place a style host array on ``device``, color-matched if asked.

    ``match_to``, a (1, H, W, 3) [0,1] host array (the content image),
    remaps the style's pixel statistics onto it on the host first: the
    ``preserve_color="match"`` path.
    """
    if match_to is not None:
        host = match_color_distribution(host, match_to)
    return host_array_to_device(host, device, normalize=normalize)


def load_style_image_to_array(
    path: str | Path,
    device: torch.device | str,
    *,
    normalize: bool = False,
    match_to: np.ndarray | None = None,
) -> torch.Tensor:
    """Load a style image file, as :func:`style_array_to_device` places it."""
    return style_array_to_device(
        load_image_to_host_array(path), device,
        normalize=normalize, match_to=match_to,
    )


def prepare_image_for_output(
    x: torch.Tensor,
    *,
    normalize: bool,
) -> torch.Tensor:
    """Make an image save-ready: denorm (optional), scrub, clip to [0,1]."""
    img = denormalize(x) if normalize else x
    img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    return torch.clamp(img, 0.0, 1.0)


def pack_uint8_frame(x: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) float in [0,1] -> (H, W, 3) uint8, on the device.

    Only H*W*3 bytes then cross to the host.
    """
    frame = torch.round(x[0] * 255.0)
    return torch.clamp(frame, 0, 255).to(torch.uint8)


def pack_uint8_frames_batch(x: torch.Tensor) -> torch.Tensor:
    """(S, 1, H, W, 3) float in [0,1] -> (S, H, W, 3) uint8, on the device.

    The multi-style batch's frame: every style's frame packed at once,
    so S*H*W*3 bytes cross to the host in one copy.
    """
    frames = torch.round(x[:, 0] * 255.0)
    return torch.clamp(frames, 0, 255).to(torch.uint8)


def array_to_uint8_frame(
    x: torch.Tensor,
    *,
    normalize: bool,
    chroma_source: torch.Tensor | None = None,
) -> np.ndarray:
    """Produce a host-side HWC uint8 frame from a working image tensor.

    ``chroma_source`` (a (1, H, W, 3) [0,1] RGB tensor, the content
    image) recolors the frame by luminance-only transfer before the
    pack: the ``preserve_color="luminance"`` path.
    """
    prepared = maybe_restore_color(
        prepare_image_for_output(x, normalize=normalize), chroma_source,
    )
    return pack_uint8_frame(prepared).cpu().numpy()


def save_array_as_image(x: torch.Tensor, path: str | Path) -> None:
    """Save a prepared (1,H,W,3) or (H,W,3) [0,1] float tensor as PNG."""
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    if x.dim() == 3:
        x = x[None]
    frame = pack_uint8_frame(x).cpu().numpy()
    Image.fromarray(frame, mode=COLOR_MODE_RGB).save(path)
