"""Shared set-up of the port's pipeline tests (sweep, regional, sequence).

Both packages get the golden corpus's 64x64 configuration
(``goldens_lib._config``: Adam at lr 0.1, taps [0, 5]/[2], content init,
seeded weights, no warm start, final image only) with the same
overrides, and each pipeline's per-step losses are read where its
frames run their steps (the module's ``drive_chunked``,
:func:`trace_frames`).
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from tests import goldens_lib

#: Per-step loss curves: relative tolerance of the JAX package's curve
#: gate (``ops/precision.py``).
CURVE_RTOL = 1e-3
#: PNGs of the two packages: uint8 levels.
LEVELS = 2
_BASE = {
    "steps": 3, "optimizer": "adam", "lr": 0.1, "style_layers": [0, 5],
    "content_layers": [2], "init_method": "content",
    "seed": goldens_lib.SEED, "allow_random_weights": True,
    "coarse_steps": 0,
}


def port_config(out: Path, **opt) -> StyleTransferConfig:
    """The corpus configuration in the port, on the CPU."""
    return StyleTransferConfig(
        output=OutputConfig(output=str(out), plot_losses=False),
        optimization=OptimizationConfig(**{**_BASE, **opt}),
        video=VideoConfig(final_only=True),
        hardware=HardwareConfig(device="cpu"),
    )


def jax_config(out: Path, **opt):
    """The corpus configuration in the JAX package."""
    return goldens_lib._config(out, **opt)  # noqa: SLF001 - the corpus's own


class FrameTrace:
    """What one package's frames did: each frame's start and end image
    (host float32) and per-step losses."""

    def __init__(self) -> None:
        """Start empty."""
        self.starts: list[np.ndarray] = []
        self.ends: list[np.ndarray] = []
        self.curves: list[np.ndarray] = []

    def assert_carried(self) -> None:
        """Each frame past 0 started from the last frame's end image."""
        for start, end in zip(self.starts[1:], self.ends, strict=False):
            np.testing.assert_array_equal(start, end)


def trace_frames(monkeypatch, module, *, replay: FrameTrace | None = None):
    """Trace ``module.drive_chunked``, one call per frame.

    A frame's budget of at most 50 steps is one chunk in both packages,
    so each call is one frame: its start image and stacked per-step
    losses are kept. With ``replay`` (the other package's trace), frame
    i starts from ``replay.starts[i]`` instead of this package's own
    frame i-1. A warm-started frame (a sequence's or a sweep's frame
    past 0) starts Adam afresh, and Adam's first steps move a value by
    about ``lr`` whatever its gradient's size: where the new frame's
    gradient is small next to its change over the two packages' 1e-3
    difference in the carried image, the two runs part by up to ``lr``
    a step (6 uint8 levels at lr 0.1) at a few values, more at each link
    of the chain. Replaying the starts holds each frame's own steps to
    the other package's from one image.
    """
    trace = FrameTrace()
    original = module.drive_chunked

    def drive(chunked_update, image, *rest):
        i = len(trace.starts)
        if replay is not None:
            start = replay.starts[i]
            image = (
                torch.from_numpy(start.copy())
                if isinstance(image, torch.Tensor)
                else jnp.asarray(start)
            )
        trace.starts.append(np.array(image, dtype=np.float32))
        image, state, auxes = original(chunked_update, image, *rest)
        trace.ends.append(np.array(image, dtype=np.float32))
        trace.curves.append(np.asarray(auxes.loss, dtype=np.float64))
        return image, state, auxes

    monkeypatch.setattr(module, "drive_chunked", drive)
    return trace


def assert_curves(ours: FrameTrace, ref: FrameTrace) -> None:
    """Same frames, same step counts, losses within ``CURVE_RTOL``."""
    assert [len(c) for c in ours.curves] == [len(c) for c in ref.curves]
    for mine, theirs in zip(ours.curves, ref.curves, strict=True):
        np.testing.assert_allclose(mine, theirs, rtol=CURVE_RTOL)


def png(path: Path) -> np.ndarray:
    """A PNG as int16 RGB, for level differences."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.int16)


def assert_pngs_close(ours: Path, ref: Path) -> None:
    """Two PNGs within ``LEVELS`` uint8 levels."""
    assert np.abs(png(ours) - png(ref)).max() <= LEVELS
