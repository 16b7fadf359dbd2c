"""Clamped Gram matrix of NHWC features, for the style losses.

The port of the JAX package's ``ops/pallas_gram.py`` (the Pallas kernel
``gram_matrix_pallas``) and ``ops/gram.py``. ``G[c1, c2] = sum_p F[p,
c1] F[p, c2]`` over all batch and spatial positions, clamped per
element at ``GRAM_MATRIX_CLAMP_MAX`` *before* dividing by B*H*W*C
(:func:`gram_matrix`). The multi-style batch needs one Gram per image
instead, as the JAX package's ``vmap`` of the single step gives it:
:func:`gram_matrix_batched` takes ``(S, H, W, C)`` to ``(S, C, C)``,
each image clamped and divided by H*W*C.

On a CUDA tensor the raw Grams and G come from the hand-written kernel
``csrc/gram.cu``, one launch per call whatever the batch, in the mode
of the Gram's precision level (``ops/precision.py``): ``tf32x3`` or
``tf32`` on the tensor cores, ``ieee`` (IEEE fp32) on the CUDA cores.
It launches that mode's kernel or raises. On a CPU tensor they come
from the plain version, ``F.T @ F`` per image, in fp32 at every mode.
Any other device raises. Each mode also has a plain version of its own
rounding (:func:`gram_plain`), which the card's checks hold the kernel
against.

The backward is the JAX package's: with ``S = (M . dG + (M . dG)^T) /
n`` and ``M = raw <= clamp``, ``dF = F S``, one ``torch.matmul`` (one
per image for a batch) outside the kernel (it lies outside the Pallas
kernel in the JAX package too), at its own level (the JAX package's
``bwd_precision``): fp32 at ``highest`` and ``high``; at ``default``,
on the card, the fp32 product of tf32-rounded operands, so TF32
products without a process-wide TF32 flag.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops.precision import (
    HIGH,
    MODES,
    Mode,
    PrecisionLike,
    gram_bwd_precision,
    gram_precision,
    kernel_mode,
)
from style_transfer_visualizer_tpu_torch.ops.tf32 import (
    round_tf32,
    split_tf32,
)

#: Launches of ``csrc/gram.cu`` made by :func:`gram_kernel`, per mode.
launches = build.ModeCounters("gram", MODES)
#: The C entry point's number of each mode.
_MODE_CODES = {"ieee": 0, "tf32x3": 1, "tf32": 2}

# Tile edge and pixel rows per ring slot of the kernel.
_TILE = 64
_ROWS = 32
# Blocks per SM the kernel's shared memory and registers allow.
_BLOCKS_PER_SM = 2
_STAGES = 4
_SLOT_BYTES = 2 * _ROWS * _TILE * 4   # the F_i and F_j slabs
_BT_BYTES = _TILE * _ROWS * 4          # one transposed B tile (hi or lo)
_ALIGN = 1024
# The grid's third dimension, one image per index.
_MAX_BATCH = 65535


@dataclass(frozen=True)
class GramPlan:
    """How ``csrc/gram.cu`` covers one ``(P, C)`` block."""

    pairs: int
    splits: int
    rows: int
    group: int
    groups: int
    stages: int
    smem_bytes: int


def _raw_plain(flat: torch.Tensor, mode: Mode) -> torch.Tensor:
    if mode == "ieee":
        return flat.T @ flat
    if mode == "tf32":
        r = round_tf32(flat)
        return r.T @ r
    if mode == "tf32x3":
        hi, lo = split_tf32(flat)
        return (lo.T @ hi + hi.T @ lo) + hi.T @ hi
    msg = f"gram: unknown mode {mode!r}"
    raise ValueError(msg)


def gram_plain(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode = "ieee",
) -> tuple[torch.Tensor, torch.Tensor]:
    """A mode's kernel function in plain PyTorch: ``(raw, G)``.

    The products are the mode's: ``ieee`` the fp32 product; ``tf32``
    the fp32 product of tf32-rounded operands (each product exact in
    fp32); ``tf32x3`` the three products of the split halves, ``lo*hi
    + hi*lo + hi*hi``. Run it with cuBLAS's TF32 off on the card (the
    default).
    """
    raw = _raw_plain(flat, mode)
    return raw, torch.clamp(raw, max=clamp_max) / norm


def gram_plain_batched(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode = "ieee",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched kernel's function: :func:`gram_plain` per image.

    ``flat`` is ``(S, P, C)``; returns ``(raw, G)``, each ``(S, C, C)``.
    """
    pairs = [gram_plain(f, clamp_max, norm, mode) for f in flat]
    return (
        torch.stack([raw for raw, _ in pairs]),
        torch.stack([g for _, g in pairs]),
    )


@functools.cache
def _entry():
    fn = build.load("gram").gram_forward
    fn.argtypes = [
        *[ctypes.c_void_p] * 5, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, *[ctypes.c_int] * 3,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def split_rows(p: int, c: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the kernel's split over P.

    Enough splits to give every SM its blocks, each a whole number of
    32-row slots; the splits cover all ``p`` rows. Each split has one
    block per tile pair on or above the diagonal.
    """
    side = math.ceil(c / _TILE)
    pairs = side * (side + 1) // 2
    groups = max(1, math.ceil(p / _ROWS))
    cap = max(1, (_BLOCKS_PER_SM * n_sm) // pairs)
    splits = max(1, min(groups, cap))
    rows = math.ceil(groups / splits) * _ROWS
    return math.ceil(p / rows) if p else 1, rows


def _smem_bytes(mode: Mode) -> int:
    """Dynamic shared memory of ``mode``'s kernel: the ring's slots,
    the transposed B tiles (hi and lo in ``tf32x3``, hi in ``tf32``) and
    the mbarriers; 0 for ``ieee``, whose shared memory is static."""
    if mode == "ieee":
        return 0
    b_tiles = 2 if mode == "tf32x3" else 1
    return _ALIGN + _STAGES * _SLOT_BYTES + b_tiles * _BT_BYTES + 16 * _STAGES


@functools.cache
def gram_plan(p: int, c: int, n_sm: int, mode: Mode = "tf32x3") -> GramPlan:
    """The kernel's launch plan for a ``(p, c)`` block (``c % 4 == 0``).

    The partial tiles of the splits are summed in groups of ``group``
    (about the square root of ``splits``), then the group sums, so no
    block reads more than about ``2 * sqrt(splits)`` tiles. A batch of
    images is planned image by image, as if each were alone: an image's
    sums run in the same order whatever the batch, so its raw Gram is
    the single launch's, bit for bit. Every mode shares the grid and the
    split; only the shared memory differs.
    """
    if mode not in MODES:
        msg = f"gram: unknown mode {mode!r}"
        raise ValueError(msg)
    side = math.ceil(c / _TILE)
    splits, rows = split_rows(p, c, n_sm)
    group = math.isqrt(splits - 1) + 1
    return GramPlan(
        pairs=side * (side + 1) // 2, splits=splits, rows=rows,
        group=group, groups=math.ceil(splits / group), stages=_STAGES,
        smem_bytes=_smem_bytes(mode),
    )


def _launch(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/gram.cu`` in ``mode`` on a contiguous ``(S,
    P, C)`` batch.

    A ``C`` that is not a multiple of 4 (TMA's 16-byte row stride, the
    IEEE kernel's float4 loads) is padded with zero channels, which add
    nothing, and cut off again.
    """
    s, p, c = flat.shape
    if c % 4:
        raw, g = _launch(F.pad(flat, (0, -c % 4)), clamp_max, norm, mode)
        return raw[:, :c, :c].contiguous(), g[:, :c, :c].contiguous()
    if not 1 <= s <= _MAX_BATCH:
        msg = f"gram kernel takes 1 to {_MAX_BATCH} images, not {s}"
        raise ValueError(msg)
    dev = flat.device
    plan = gram_plan(p, c, build.sm_count(dev.index), mode)
    # raw and the partial tiles' workspace in one allocation: raw lives
    # only until the backward; G, which a style target keeps for the
    # whole run, has its own.
    cc = s * c * c
    buf = torch.empty(
        cc + s * plan.pairs * (plan.splits + plan.groups) * _TILE * _TILE,
        device=dev, dtype=flat.dtype,
    )
    raw = buf[:cc].view(s, c, c)
    g = torch.empty((s, c, c), device=dev, dtype=flat.dtype)
    counters = build.arrival_counters(dev, s * plan.pairs * (plan.groups + 1))
    status = _entry()(
        flat.data_ptr(), buf[cc:].data_ptr(), counters.data_ptr(),
        raw.data_ptr(), g.data_ptr(), s, p, c, plan.splits, plan.rows,
        plan.group, plan.stages, plan.smem_bytes, clamp_max, norm,
        launches[mode].slot(dev).data_ptr(), _MODE_CODES[mode], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "gram")
    launches[mode].count += 1
    return raw, g


def _check_cuda(flat: torch.Tensor, dims: int, what: str) -> None:
    if flat.device.type != "cuda" or flat.dtype != torch.float32:
        msg = "gram kernel takes a float32 CUDA tensor"
        raise ValueError(msg)
    if flat.dim() != dims or not flat.is_contiguous():
        msg = f"gram kernel takes a contiguous {what} block: {flat.shape}"
        raise ValueError(msg)


def gram_kernel(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode = "tf32x3",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/gram.cu`` in ``mode`` on a CUDA ``(P, C)`` block:
    ``(raw, G)``.

    One call is one kernel launch: the split partial tiles and their
    fixed-order sum, with the clamp and scale fused. An unknown mode
    raises.
    """
    _check_cuda(flat, 2, "(P, C)")
    raw, g = _launch(flat[None], clamp_max, norm, mode)
    return raw[0], g[0]


def gram_kernel_batched(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode = "tf32x3",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/gram.cu`` in ``mode`` once on a CUDA ``(S, P, C)``
    batch.

    Returns ``(raw, G)``, each ``(S, C, C)``: image s's Gram, clamped
    and divided by ``norm``, bit for bit as :func:`gram_kernel` gives
    it for that image alone.
    """
    _check_cuda(flat, 3, "(S, P, C)")
    return _launch(flat, clamp_max, norm, mode)


def _gram(
    flat: torch.Tensor,
    clamp_max: float,
    norm: float,
    mode: Mode,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(raw, G)`` of a ``(P, C)`` block or an ``(S, P, C)`` batch."""
    batched = flat.dim() == 3  # noqa: PLR2004
    if flat.device.type == "cuda":
        kernel = gram_kernel_batched if batched else gram_kernel
        return kernel(flat, clamp_max, norm, mode)
    if flat.device.type == "cpu":
        plain = gram_plain_batched if batched else gram_plain
        return plain(flat, clamp_max, norm)
    msg = f"gram runs on CUDA or CPU tensors, not {flat.device}"
    raise ValueError(msg)


def _bwd_operands(
    flat: torch.Tensor, sym: torch.Tensor, bwd_mode: Mode,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward product's operands: tf32-rounded in the ``tf32``
    mode on the card (exact products, fp32 sums), as they are
    otherwise."""
    if bwd_mode == "tf32" and flat.device.type == "cuda":
        return round_tf32(flat), round_tf32(sym)
    return flat, sym


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, clamp_max, norm, mode, bwd_mode):
        """Clamped, normalized Gram in ``mode``; keep F and the raw
        Gram."""
        raw, g = _gram(flat, clamp_max, norm, mode)
        ctx.save_for_backward(flat, raw)
        ctx.clamp_max = clamp_max
        ctx.norm = norm
        ctx.bwd_mode = bwd_mode
        return g

    @staticmethod
    def backward(ctx, dg):
        """``dF = F S`` with the clamp's pass-through mask in ``S``.

        For a batch, one product per image, each the single run's:
        image s's gradient comes from its own Gram only, bit for bit as
        alone.
        """
        flat, raw = ctx.saved_tensors
        mask = (raw <= ctx.clamp_max).to(dg.dtype)
        scaled = mask * dg / ctx.norm
        sym = scaled + scaled.mT
        flat, sym = _bwd_operands(flat, sym, ctx.bwd_mode)
        if flat.dim() == 2:  # noqa: PLR2004
            return flat @ sym, None, None, None, None
        grad = torch.empty_like(flat)
        for f, g_sym, out in zip(flat, sym, grad, strict=True):
            torch.mm(f, g_sym, out=out)
        return grad, None, None, None, None


def _modes(precision: PrecisionLike) -> tuple[Mode, Mode]:
    """The Gram's forward and backward modes under a tier or policy."""
    return (
        kernel_mode(gram_precision(precision)),
        kernel_mode(gram_bwd_precision(precision)),
    )


def gram_matrix(
    features: torch.Tensor,
    clamp_max: float = GRAM_MATRIX_CLAMP_MAX,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """The (C, C) Gram matrix of a (B, H, W, C) feature map.

    The batch folds into the pixel sum; the result is clamped at
    ``clamp_max`` and then divided by B*H*W*C. ``precision`` (a level
    or a policy, ``ops/precision.py``) sets the forward's and the
    backward's modes; ``high`` (3xTF32) unless given.
    """
    b, h, w, c = features.shape
    flat = features.contiguous().reshape(b * h * w, c)
    return _GramFn.apply(
        flat, float(clamp_max), float(b * h * w * c), *_modes(precision),
    )


def gram_matrix_batched(
    features: torch.Tensor,
    clamp_max: float = GRAM_MATRIX_CLAMP_MAX,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """The (S, C, C) Gram matrices of an (S, H, W, C) batch, one per image.

    Each image's Gram is clamped at ``clamp_max`` and then divided by
    H*W*C: the JAX package's :func:`gram_matrix` under ``vmap``. One
    kernel launch for the whole batch on the card; ``precision`` as in
    :func:`gram_matrix`.
    """
    s, h, w, c = features.shape
    flat = features.contiguous().reshape(s, h * w, c)
    return _GramFn.apply(
        flat, float(clamp_max), float(h * w * c), *_modes(precision),
    )
