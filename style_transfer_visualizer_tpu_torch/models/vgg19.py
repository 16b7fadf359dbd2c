"""VGG19 weights for the port: seeded, from ``.npz``, or from JAX.

A layer's parameters are the conv kernel as a ``(9, C_in, C_out)``
stencil (HWIO reshaped row-major over ``(ky, kx)``, the layout of the
JAX package's ``pallas_conv.hwio_to_stencil``), its backward stencil
``w9_flip`` (rot180 + channel transpose, ``(9, C_out, C_in)``) and the
bias. For the tensor-core kernel each stencil is also packed K-major,
``(C_out, Kp)`` with ``K = tap * C_in + c`` zero-padded to ``Kp``, a
multiple of 32, and split into tf32 hi and lo halves (``ops/tf32.py``):
``wk_hi``/``wk_lo`` from ``w9`` for the forward, ``wkf_hi``/``wkf_lo``
from ``w9_flip`` for the input gradient. The backbone is frozen: only
pixels are optimized, so the flipped and packed copies are made once
when the weights are loaded, never per step.

Params: ``{layer_index: {"w9", "w9_flip", "b", "wk_hi", "wk_lo",
"wkf_hi", "wkf_lo"}}``.
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch.models.arch import (
    VGG19,
    Architecture,
)
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import K_STEP
from style_transfer_visualizer_tpu_torch.ops.tf32 import split_tf32
from style_transfer_visualizer_tpu_torch.utils.logging import logger

Params = dict[int, dict[str, torch.Tensor]]
HostParams = dict[int, dict[str, np.ndarray]]


def flip_stencil(w9: torch.Tensor) -> torch.Tensor:
    """rot180 + channel transpose: the stencil of the input gradient."""
    return torch.flip(w9, dims=(0,)).transpose(1, 2).contiguous()


def pack_stencil(w9: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K-major tf32 ``(hi, lo)`` of a ``(9, C_in, C_out)`` stencil.

    Each is ``(C_out, Kp)``: column ``tap * C_in + c`` holds ``w9[tap,
    c]``, columns from ``9 * C_in`` up to ``Kp`` (a multiple of
    ``K_STEP``) are zero.
    """
    nine, c_in, c_out = w9.shape
    k = nine * c_in
    wk = torch.zeros(
        (c_out, -(-k // K_STEP) * K_STEP), dtype=w9.dtype, device=w9.device,
    )
    wk[:, :k] = w9.reshape(k, c_out).T
    return split_tf32(wk)


def _layer(w9: torch.Tensor, b: torch.Tensor) -> dict[str, torch.Tensor]:
    w9_flip = flip_stencil(w9)
    wk_hi, wk_lo = pack_stencil(w9)
    wkf_hi, wkf_lo = pack_stencil(w9_flip)
    return {
        "w9": w9, "w9_flip": w9_flip, "b": b, "wk_hi": wk_hi,
        "wk_lo": wk_lo, "wkf_hi": wkf_hi, "wkf_lo": wkf_lo,
    }


def init_random_host_params(
    seed: int,
    arch: Architecture = VGG19,
) -> HostParams:
    """He-normal HWIO weights and zero biases drawn with numpy.

    The draws repeat the JAX package's ``vgg19.init_random_params``
    in the same order, so both packages get the same weights bit for
    bit from the same seed.
    """
    rng = np.random.default_rng(int(seed))
    host: HostParams = {}
    for idx in arch.conv_indices:
        _, in_ch, out_ch = arch.layer_table[idx]
        fan_in = 3 * 3 * in_ch
        host[idx] = {
            "w": (
                rng.standard_normal((3, 3, in_ch, out_ch))
                * np.sqrt(2.0 / fan_in)
            ).astype(np.float32),
            "b": np.zeros((out_ch,), np.float32),
        }
    return host


def params_from_numpy(
    host: Mapping[int, Mapping[str, object]],
    device: torch.device | str,
) -> Params:
    """Carry HWIO ``{"w", "b"}`` arrays (numpy or JAX) onto ``device``.

    Each ``(3, 3, C_in, C_out)`` kernel becomes the ``(9, C_in,
    C_out)`` stencil, its flipped backward stencil and the packed tf32
    halves of both.
    """
    params: Params = {}
    for idx, layer in host.items():
        w = np.asarray(layer["w"], dtype=np.float32)
        kh, kw, c_in, c_out = w.shape
        if (kh, kw) != (3, 3):
            msg = f"Layer {idx}: expected a 3x3 kernel, got {kh}x{kw}"
            raise ValueError(msg)
        w9 = torch.tensor(w.reshape(9, c_in, c_out), device=device)
        b = torch.tensor(
            np.asarray(layer["b"], dtype=np.float32), device=device,
        )
        params[int(idx)] = _layer(w9, b)
    return params


def params_to_numpy(params: Params) -> HostParams:
    """Inverse of :func:`params_from_numpy`: HWIO numpy arrays."""
    host: HostParams = {}
    for idx, layer in params.items():
        w9 = layer["w9"].detach().cpu().numpy()
        _, c_in, c_out = w9.shape
        host[idx] = {
            "w": w9.reshape(3, 3, c_in, c_out),
            "b": layer["b"].detach().cpu().numpy(),
        }
    return host


def init_random_params(
    seed: int,
    device: torch.device | str,
    arch: Architecture = VGG19,
) -> Params:
    """Seeded He-normal weights on ``device`` (see the host draw)."""
    return params_from_numpy(init_random_host_params(seed, arch), device)


def load_params_npz(path: Path, device: torch.device | str) -> Params:
    """Load params from the JAX package's flat ``.npz`` layout.

    Keys are ``w{idx}`` (HWIO) and ``b{idx}``; conv indices come from
    the archive's own key set.
    """
    with np.load(path) as data:
        indices = sorted(int(k[1:]) for k in data.files if k.startswith("w"))
        host = {
            idx: {"w": data[f"w{idx}"], "b": data[f"b{idx}"]}
            for idx in indices
        }
    return params_from_numpy(host, device)


def default_cache_dir() -> Path:
    """Where the JAX package caches converted weights."""
    base = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(base) / "style_transfer_visualizer_tpu"


def load_pretrained_params(
    device: torch.device | str,
    *,
    arch: Architecture = VGG19,
    cache_dir: Path | None = None,
    allow_random: bool = False,
    seed: int = 0,
) -> Params:
    """Load converted pretrained weights, or seeded ones when allowed.

    Order: the ``.npz`` archive in ``cache_dir`` -> seeded random
    weights (only with ``allow_random=True``, logged loudly since
    stylization quality depends on pretrained features).
    """
    cache_path = (cache_dir or default_cache_dir()) / arch.cache_filename
    model = arch.name.upper()
    if cache_path.exists():
        logger.info("Using cached %s weights at %s", model, cache_path)
        return load_params_npz(cache_path, device)
    if allow_random:
        logger.warning(
            "Pretrained %s weights unavailable (no archive at %s); using "
            "seeded random weights. Stylization quality will be poor.",
            model, cache_path,
        )
        return init_random_params(seed, device, arch)
    msg = (
        f"{model} weights not found at {cache_path}; convert them with "
        "the JAX package's stv-fetch-weights, or pass "
        "allow_random=True."
    )
    raise FileNotFoundError(msg)
