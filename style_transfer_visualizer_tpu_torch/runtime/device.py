"""Device selection and deterministic seeding.

Unlike the JAX package's ``setup_device``, a device that is asked for
and absent raises: nothing falls back to the CPU. The CPU runs only
when the caller asks for it by name.
"""
from __future__ import annotations

import random

import torch

from style_transfer_visualizer_tpu_torch.utils.logging import logger


def setup_device(device_name: str) -> torch.device:
    """Return the ``torch.device`` to run on, or raise if it is absent.

    ``"cuda"`` (or ``"cuda:N"``) needs a CUDA device; ``"cpu"`` always
    works. Any other name raises ``ValueError``.
    """
    device = torch.device(device_name.lower())
    if device.type == "cuda":
        if not torch.cuda.is_available():
            msg = (
                f"{device_name!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
            raise RuntimeError(msg)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        msg = f"Unknown device: {device_name!r}"
        raise ValueError(msg)
    logger.info("Using device: %s", device)
    return device


def setup_random_seed(seed: int, device: torch.device) -> torch.Generator:
    """Seed host-side RNGs and return a generator on ``device``.

    All device-side randomness of a run draws from the returned
    generator; Python's ``random`` is seeded for host-side consumers.
    """
    random.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
