"""Color preservation (Gatys et al. 2016, arXiv:1606.05897).

The port of the JAX package's ``ops/color.py``:

- **Luminance-only transfer** (:func:`luminance_transfer`): the
  stylized luminance over the content's chrominance, in YIQ. A
  per-pixel linear map on the tensor's own device, so timelapse frames
  are recolored on the card before they are packed.
- **Color matching** (:func:`match_color_distribution`): the style
  image's pixels remapped onto the content's mean and 3x3 covariance
  before the Gram targets are made. Host numpy in float64, the same
  arithmetic as the JAX package's, so both give the same array.
"""
from __future__ import annotations

from functools import cache

import numpy as np
import torch

#: NTSC RGB -> YIQ, float64. Row 0 is the luma (Rec. 601 weights); rows
#: 1-2 carry chrominance. The inverse is derived numerically, as in the
#: JAX package, so the round trip is exact to float rounding.
RGB_TO_YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.595716, -0.274453, -0.321263],
        [0.211456, -0.522591, 0.311135],
    ],
    dtype=np.float64,
)
YIQ_TO_RGB = np.linalg.inv(RGB_TO_YIQ)
# Eigenvalue floor of the covariance square roots: solid or gray
# palettes have rank-deficient covariances.
_EIG_FLOOR = 1e-8


@cache
def yiq_matrices(
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 RGB->YIQ and YIQ->RGB matrices, once per device.

    Made per call, their pageable copy to the card would wait for the
    device's stream, which the timelapse frame path must not: callers
    on that path make them before the loop starts.
    """
    return (
        torch.tensor(RGB_TO_YIQ, dtype=torch.float32, device=device),
        torch.tensor(YIQ_TO_RGB, dtype=torch.float32, device=device),
    )


def rgb_to_yiq(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0,1] -> YIQ (luma in [0,1], chroma signed)."""
    return rgb @ yiq_matrices(rgb.device)[0].T


def yiq_to_rgb(yiq: torch.Tensor) -> torch.Tensor:
    """(..., 3) YIQ -> RGB (unclipped; callers clip to [0,1])."""
    return yiq @ yiq_matrices(yiq.device)[1].T


def luminance_transfer(
    stylized: torch.Tensor,
    content: torch.Tensor,
) -> torch.Tensor:
    """Stylized luminance over content chrominance, in [0,1] RGB.

    Both inputs are (..., H, W, 3) RGB in [0,1] whose shapes broadcast
    (a batch of stylized images against one content image). Returns RGB
    clipped to [0,1].
    """
    y = rgb_to_yiq(stylized)[..., :1]
    iq = rgb_to_yiq(content)[..., 1:]
    lead = torch.broadcast_shapes(y.shape[:-1], iq.shape[:-1])
    yiq = torch.cat(
        [y.expand(*lead, 1), iq.expand(*lead, 2)], dim=-1,
    )
    return torch.clamp(yiq_to_rgb(yiq), 0.0, 1.0)


def maybe_restore_color(
    img: torch.Tensor,
    chroma_source: torch.Tensor | None,
) -> torch.Tensor:
    """Apply :func:`luminance_transfer` when a chroma source is set."""
    if chroma_source is None:
        return img
    return luminance_transfer(img, chroma_source)


def _pixel_stats(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean (3,) and covariance (3, 3) over all pixels of (..., 3)."""
    flat = arr.reshape(-1, 3).astype(np.float64)
    mu = flat.mean(axis=0)
    centered = flat - mu
    cov = centered.T @ centered / flat.shape[0]
    return mu, cov


def _sqrt_psd(cov: np.ndarray, *, inverse: bool = False) -> np.ndarray:
    """Symmetric (inverse) square root of a 3x3 PSD matrix.

    Eigenvalues are floored, so a degenerate palette gives a finite
    transform instead of NaNs.
    """
    eigval, eigvec = np.linalg.eigh(cov)
    root = np.sqrt(np.maximum(eigval, _EIG_FLOOR))
    if inverse:
        root = 1.0 / root
    return (eigvec * root) @ eigvec.T


def match_color_distribution(
    style: np.ndarray,
    content: np.ndarray,
) -> np.ndarray:
    """Remap ``style``'s colors onto ``content``'s palette statistics.

    Host-side, float64: ``A = cov_c^{1/2} cov_s^{-1/2}`` (symmetric
    square roots) maps the style pixels so their mean and covariance
    equal the content's. Inputs are (..., 3) RGB in [0,1]; the output
    has ``style``'s shape and dtype, clipped to [0,1].
    """
    mu_s, cov_s = _pixel_stats(style)
    mu_c, cov_c = _pixel_stats(content)
    transform = _sqrt_psd(cov_c) @ _sqrt_psd(cov_s, inverse=True)
    flat = style.reshape(-1, 3).astype(np.float64)
    matched = (flat - mu_s) @ transform.T + mu_c
    matched = np.clip(matched, 0.0, 1.0)
    return matched.reshape(style.shape).astype(style.dtype)
