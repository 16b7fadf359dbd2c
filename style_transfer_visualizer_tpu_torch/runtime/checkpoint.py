"""Resumable checkpoints of the port: the image, the optimizer state, the step.

The port of the JAX package's ``runtime/checkpoint.py``. A checkpoint is
one ``.npz`` with the keys ``image``, ``__meta__`` (JSON: ``step``,
``n_leaves``, ``bf16_leaves``, ``optimizer``, ``layout``) and
``state_<i>``, one per field of the optimizer state in the field order
of the port's dataclasses (:class:`~.engine.optimizers.LbfgsState`,
:class:`~.engine.optimizers.AdamState`; the batch's state has a leading
style axis on every field). bfloat16 leaves are stored as uint16 bit
patterns. Writes go through a temp file and a rename, so an interrupted
save never corrupts the previous checkpoint.

A save reads the device once: every leaf and the image are packed into
one byte buffer on the device, copied to the host in one transfer and
split there. The runner calls it only at its ``checkpoint_every``
cadence, so nothing else adds a host sync to the step.

``layout`` names the state's fields. A file without it (one written by
the JAX package, whose state pytree is another layout: int32 counters,
other shapes) is refused with ``ValueError``, never loaded scrambled.
The JAX loader's flat-to-shaped Adam migration serves files of older
JAX builds; the port has no older files, so it has no such migration.
"""
from __future__ import annotations

import json
from dataclasses import fields
from pathlib import Path
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    AdamState,
    LbfgsState,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.engine.step import OptState

_META_KEY = "__meta__"
_IMAGE_KEY = "image"
_STATE_PREFIX = "state_"
_OPTIMIZERS = {LbfgsState: "lbfgs", AdamState: "adam"}
# numpy's view of each stored dtype; bfloat16 has none and is kept as
# its uint16 bit pattern.
_HOST_DTYPES = {
    torch.float32: np.float32,
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.bfloat16: np.uint16,
}


class Checkpoint(NamedTuple):
    """A restored checkpoint, on the device it was loaded to."""

    step: int
    image: torch.Tensor
    opt_state: OptState


def _leaves(state: OptState) -> list[tuple[str, torch.Tensor]]:
    return [(f.name, getattr(state, f.name)) for f in fields(state)]


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Every tensor on the host, in one device-to-host transfer."""
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    packed = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out: list[np.ndarray] = []
    offset = 0
    for t, src in zip(flat, tensors, strict=True):
        nbytes = t.numel() * t.element_size()
        out.append(
            packed[offset:offset + nbytes]
            .view(_HOST_DTYPES[t.dtype])
            .reshape(tuple(src.shape)),
        )
        offset += nbytes
    return out


def save_checkpoint(
    path: str | Path,
    step: int,
    image: torch.Tensor,
    opt_state: OptState,
) -> Path:
    """Atomically write (step, image, optimizer state) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    named = _leaves(opt_state)
    host_image, *host_leaves = _to_host([image] + [t for _, t in named])
    meta = {
        "step": int(step),
        "n_leaves": len(named),
        "bf16_leaves": [
            i for i, (_, t) in enumerate(named) if t.dtype == torch.bfloat16
        ],
        "optimizer": _OPTIMIZERS[type(opt_state)],
        "layout": [name for name, _ in named],
    }
    payload = {
        _IMAGE_KEY: host_image,
        _META_KEY: np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"{_STATE_PREFIX}{i}": a for i, a in enumerate(host_leaves)},
    }
    # A name ending in .npz keeps np.savez from appending another.
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(path)
    logger.info("Checkpoint saved at step %d: %s", step, path)
    return path


def load_checkpoint(
    path: str | Path,
    state_like: OptState,
    device: torch.device | str,
) -> Checkpoint:
    """Restore a checkpoint onto ``device``.

    ``state_like`` (the freshly built state of the current run) gives
    the fields, shapes and dtypes. Raises ``FileNotFoundError`` for a
    missing file and ``ValueError`` for a file without the port's
    layout, another optimizer, another leaf count or another leaf
    shape. A leaf whose dtype differs (the L-BFGS ring saved as f32 and
    resumed under ``lbfgs_history_dtype="bfloat16"``, or the reverse)
    is cast to the current configuration's dtype, with a log line.
    """
    path = Path(path)
    if not path.is_file():
        msg = f"Checkpoint not found: {path}"
        raise FileNotFoundError(msg)
    like = _leaves(state_like)
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
        if "layout" not in meta:
            msg = (
                f"Checkpoint {path} does not record the port's state "
                "layout (a checkpoint written by the JAX package keeps "
                "its optimizer state in another layout); it cannot be "
                "resumed here."
            )
            raise ValueError(msg)
        if meta["n_leaves"] != len(like):
            msg = (
                f"Checkpoint has {meta['n_leaves']} state leaves but the "
                f"current optimizer expects {len(like)}: was it saved "
                "with a different optimizer configuration?"
            )
            raise ValueError(msg)
        if meta["layout"] != [name for name, _ in like]:
            msg = (
                f"Checkpoint state is {meta['optimizer']} "
                f"({meta['layout']}), but the current optimizer is "
                f"{_OPTIMIZERS[type(state_like)]}: a different optimizer "
                "configuration."
            )
            raise ValueError(msg)
        bf16 = set(meta["bf16_leaves"])
        leaves: dict[str, torch.Tensor] = {}
        for i, (name, ref) in enumerate(like):
            arr = data[f"{_STATE_PREFIX}{i}"]
            if arr.shape != tuple(ref.shape):
                msg = (
                    f"Checkpoint state leaf {i} ({name}) has shape "
                    f"{arr.shape} but the current optimizer expects "
                    f"{tuple(ref.shape)}: the checkpoint was saved with "
                    "an incompatible configuration."
                )
                raise ValueError(msg)
            leaf = torch.from_numpy(arr.view(np.int16) if i in bf16 else arr)
            if i in bf16:
                leaf = leaf.view(torch.bfloat16)
            if leaf.dtype != ref.dtype:
                logger.info(
                    "Casting checkpoint state leaf %d (%s) from %s to %s "
                    "to match the current optimizer configuration.",
                    i, name, leaf.dtype, ref.dtype,
                )
                leaf = leaf.to(ref.dtype)
            leaves[name] = leaf.to(device)
        image = torch.from_numpy(data[_IMAGE_KEY]).to(device)
    logger.info("Resumed checkpoint from step %d: %s", meta["step"], path)
    return Checkpoint(
        step=int(meta["step"]),
        image=image,
        opt_state=type(state_like)(**leaves),
    )
