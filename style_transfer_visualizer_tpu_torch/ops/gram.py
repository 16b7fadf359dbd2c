"""Clamped Gram matrix of NHWC features, for the style losses.

The port of the JAX package's ``ops/pallas_gram.py`` (the Pallas kernel
``gram_matrix_pallas``) and ``ops/gram.py``. ``G[c1, c2] = sum_p F[p,
c1] F[p, c2]`` over all batch and spatial positions, clamped per
element at ``GRAM_MATRIX_CLAMP_MAX`` *before* dividing by B*H*W*C.

On a CUDA tensor the raw Gram and G come from the hand-written kernel
``csrc/gram.cu``; on a CPU tensor from the plain version,
``F.T @ F``. Any other device raises. The backward is the JAX
package's: with ``S = (M . dG + (M . dG)^T) / n`` and ``M = raw <=
clamp``, ``dF = F S``, one ``torch.matmul`` outside the kernel (it lies
outside the Pallas kernel in the JAX package too).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.native import build

#: Launches of ``csrc/gram.cu`` made by :func:`gram_kernel`.
launches = build.LaunchCounter("gram")

# Tile edge and pixel rows per stage of the kernel's first stage.
_TILE = 64
_ROWS = 16
# Blocks aimed for per SM when the pixel sum is split.
_BLOCKS_PER_SM = 4


def gram_plain(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``(raw, G)``."""
    raw = flat.T @ flat
    return raw, torch.clamp(raw, max=clamp_max) / norm


@functools.cache
def _entry():
    fn = build.load("gram").gram_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def split_rows(p: int, c: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the kernel's split over P.

    Enough splits to give every SM a few blocks, each a whole number of
    staged row groups; the splits cover all ``p`` rows. Each split has
    one block per tile pair on or above the diagonal.
    """
    side = math.ceil(c / _TILE)
    tiles = side * (side + 1) // 2
    groups = max(1, math.ceil(p / _ROWS))
    splits = max(1, min(groups, (_BLOCKS_PER_SM * n_sm) // tiles))
    rows = math.ceil(groups / splits) * _ROWS
    return math.ceil(p / rows) if p else 1, rows


def gram_kernel(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/gram.cu`` on a CUDA ``(P, C)`` block: ``(raw, G)``.

    One call launches the kernel's two stages (the partial tiles, then
    their fixed-order sum) and counts once.
    """
    if flat.device.type != "cuda" or flat.dtype != torch.float32:
        msg = "gram kernel takes a float32 CUDA tensor"
        raise ValueError(msg)
    if flat.dim() != 2 or not flat.is_contiguous():
        msg = f"gram kernel takes a contiguous (P, C) block: {flat.shape}"
        raise ValueError(msg)
    p, c = flat.shape
    n_sm = torch.cuda.get_device_properties(flat.device).multi_processor_count
    splits, rows = split_rows(p, c, n_sm)
    ws = torch.empty((splits, c, c), device=flat.device, dtype=flat.dtype)
    raw = torch.empty((c, c), device=flat.device, dtype=flat.dtype)
    g = torch.empty_like(raw)
    status = _entry()(
        flat.data_ptr(), ws.data_ptr(), raw.data_ptr(), g.data_ptr(),
        p, c, splits, rows, clamp_max, norm,
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    build.check(status, "gram")
    launches.count += 1
    return raw, g


def _gram(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    if flat.device.type == "cuda":
        return gram_kernel(flat, clamp_max, norm)
    if flat.device.type == "cpu":
        return gram_plain(flat, clamp_max, norm)
    msg = f"gram runs on CUDA or CPU tensors, not {flat.device}"
    raise ValueError(msg)


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, clamp_max, norm):
        """Clamped, normalized Gram; keep F and the raw Gram."""
        raw, g = _gram(flat, clamp_max, norm)
        ctx.save_for_backward(flat, raw)
        ctx.clamp_max = clamp_max
        ctx.norm = norm
        return g

    @staticmethod
    def backward(ctx, dg):
        """``dF = F S`` with the clamp's pass-through mask in ``S``."""
        flat, raw = ctx.saved_tensors
        mask = (raw <= ctx.clamp_max).to(dg.dtype)
        scaled = mask * dg / ctx.norm
        return flat @ (scaled + scaled.T), None, None


def gram_matrix(
    features: torch.Tensor,
    clamp_max: float = GRAM_MATRIX_CLAMP_MAX,
) -> torch.Tensor:
    """The (C, C) Gram matrix of a (B, H, W, C) feature map.

    The batch folds into the pixel sum; the result is clamped at
    ``clamp_max`` and then divided by B*H*W*C.
    """
    b, h, w, c = features.shape
    flat = features.contiguous().reshape(b * h * w, c)
    return _GramFn.apply(flat, float(clamp_max), float(b * h * w * c))
