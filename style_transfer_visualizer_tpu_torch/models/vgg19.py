"""VGG weights for the port: seeded, from ``.npz``, or from a ``.pth``.

A layer's parameters are the conv kernel as a ``(9, C_in, C_out)``
stencil (HWIO reshaped row-major over ``(ky, kx)``, the layout of the
JAX package's ``pallas_conv.hwio_to_stencil``), its backward stencil
``w9_flip`` (rot180 + channel transpose, ``(9, C_out, C_in)``) and the
bias. For the tensor-core kernel each stencil is also packed K-major,
``(C_out, Kp)`` with ``K = tap * C_in + c`` zero-padded to ``Kp``, a
multiple of 32, and split into tf32 hi and lo halves (``ops/tf32.py``):
``wk_hi``/``wk_lo`` from ``w9`` for the forward, ``wkf_hi``/``wkf_lo``
from ``w9_flip`` for the input gradient. Each kernel mode reads its own
form (``ops.conv3x3.mode_stencil``): the IEEE fp32 kernel the unsplit
``w9``/``w9_flip``, the TF32 kernel ``wk_hi``/``wkf_hi``, the 3xTF32
kernel both halves. The backbone is frozen: only pixels are optimized,
so the flipped and packed copies are made once when the weights are
loaded, never per step.

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
    """Where converted weights are cached: the JAX package's directory.

    Both packages read and write the same flat ``.npz`` there.
    """
    base = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(base) / "style_transfer_visualizer_tpu"


def convert_torch_state_dict(
    state_dict: Mapping[str, object],
    arch: Architecture = VGG19,
) -> HostParams:
    """HWIO host params of a torchvision VGG ``features`` state dict.

    Takes the bare ``{i}.weight`` keys of a ``.features`` dump or the
    ``features.{i}.weight`` keys of a whole model. Each OIHW kernel is
    checked against ``arch``'s layer table and transposed to HWIO.
    Raises ``KeyError`` for a missing conv layer and ``ValueError`` for
    a kernel of the wrong shape.
    """
    host: HostParams = {}
    for idx in arch.conv_indices:
        found = None
        for prefix in (f"features.{idx}", f"{idx}"):
            wkey, bkey = f"{prefix}.weight", f"{prefix}.bias"
            if wkey in state_dict and bkey in state_dict:
                found = (state_dict[wkey], state_dict[bkey])
                break
        if found is None:
            msg = f"State dict is missing conv layer {idx}"
            raise KeyError(msg)
        w_oihw, b = (np.asarray(t, dtype=np.float32) for t in found)
        _, in_ch, out_ch = arch.layer_table[idx]
        if w_oihw.shape != (out_ch, in_ch, 3, 3):
            msg = (
                f"Layer {idx}: expected OIHW {(out_ch, in_ch, 3, 3)}, "
                f"got {w_oihw.shape}"
            )
            raise ValueError(msg)
        host[idx] = {"w": w_oihw.transpose(2, 3, 1, 0), "b": b}
    return host


def save_params_npz(
    host: Mapping[int, Mapping[str, object]],
    path: Path,
) -> None:
    """Write HWIO host params as the JAX package's flat ``.npz``.

    Keys ``w{idx}`` and ``b{idx}``; written through a temp file and a
    rename, so an interrupted conversion never leaves a truncated cache.
    """
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for idx, layer in host.items():
        flat[f"w{idx}"] = np.asarray(layer["w"])
        flat[f"b{idx}"] = np.asarray(layer["b"])
    # A name ending in .npz keeps np.savez from appending another.
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **flat)
    tmp.replace(path)


def _find_torch_checkpoint(arch: Architecture = VGG19) -> Path | None:
    """A torchvision checkpoint of ``arch`` in torch hub's directories.

    ``$TORCH_HOME/hub/checkpoints`` first, then
    ``~/.cache/torch/hub/checkpoints``; the first match of
    ``arch.checkpoint_globs`` in sorted order.
    """
    candidates = []
    hub_dir = os.environ.get("TORCH_HOME")
    if hub_dir:
        candidates.append(Path(hub_dir) / "hub" / "checkpoints")
    candidates.append(Path.home() / ".cache" / "torch" / "hub" / "checkpoints")
    for directory in candidates:
        if not directory.is_dir():
            continue
        for pattern in arch.checkpoint_globs:
            for hit in sorted(directory.glob(pattern)):
                return hit
    return None


def _convert_checkpoint(
    checkpoint: Path,
    arch: Architecture = VGG19,
) -> HostParams:
    """HWIO host params of a torchvision ``.pth`` (tensors only)."""
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, arch,
    )


def load_pretrained_params(
    device: torch.device | str,
    *,
    arch: Architecture = VGG19,
    cache_dir: Path | None = None,
    allow_random: bool = False,
    seed: int = 0,
) -> Params:
    """Load pretrained weights, converting and caching; else seeded ones.

    Order: the ``.npz`` archive in ``cache_dir`` -> a torchvision
    ``.pth`` under torch hub's directories, converted and cached there
    -> seeded random weights (only with ``allow_random=True``, logged
    loudly since stylization quality depends on pretrained features).
    """
    cache_path = (cache_dir or default_cache_dir()) / arch.cache_filename
    model = arch.name.upper()
    if cache_path.exists():
        logger.info("Using cached %s weights at %s", model, cache_path)
        return load_params_npz(cache_path, device)
    checkpoint = _find_torch_checkpoint(arch)
    if checkpoint is not None:
        logger.info(
            "Converting %s weights from %s to %s",
            model, checkpoint, cache_path,
        )
        host = _convert_checkpoint(checkpoint, arch)
        save_params_npz(host, cache_path)
        return params_from_numpy(host, device)
    if allow_random:
        logger.warning(
            "Pretrained %s weights unavailable (no cache at %s, no torch "
            "checkpoint found); using seeded random weights. Stylization "
            "quality will be poor.",
            model, cache_path,
        )
        return init_random_params(seed, device, arch)
    msg = (
        f"{model} weights not found. Place a torchvision checkpoint "
        f"({' or '.join(arch.checkpoint_globs)}) under "
        "~/.cache/torch/hub/checkpoints/ and run "
        "`python -m style_transfer_visualizer_tpu_torch.tools."
        f"fetch_weights --model {arch.name}` (stv-fetch-weights-torch), "
        f"or put a converted archive at {cache_path}, or pass "
        "allow_random=True."
    )
    raise FileNotFoundError(msg)
