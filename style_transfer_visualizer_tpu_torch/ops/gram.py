"""Clamped Gram matrix of NHWC features, for the style losses.

The port of the JAX package's ``ops/pallas_gram.py`` (the Pallas kernel
``gram_matrix_pallas``) and ``ops/gram.py``. ``G[c1, c2] = sum_p F[p,
c1] F[p, c2]`` over all batch and spatial positions, clamped per
element at ``GRAM_MATRIX_CLAMP_MAX`` *before* dividing by B*H*W*C
(:func:`gram_matrix`); :func:`gram_raw` is the unclamped, undivided
sum a band of ``ops/tiled.py`` adds up. The multi-style batch needs one
Gram per image instead, as the JAX package's ``vmap`` of the single
step gives it:
:func:`gram_matrix_batched` takes ``(S, H, W, C)`` to ``(S, C, C)``,
each image clamped and divided by H*W*C, and :func:`gram_raw_batched`
gives one raw sum per image (a dp x sp rank's shard partials).

On a CUDA tensor the raw Grams and G come from the hand-written kernel
``csrc/gram.cu``, one launch per call whatever the batch, in the mode
of the Gram's precision level (``ops/precision.py``): ``tf32x3`` or
``tf32`` on the tensor cores (``tf32`` its own kernel, with its
products kept in flight and slabs of 64 rows), ``ieee`` (IEEE fp32) on
the CUDA cores (its own kernel and plan: a ``cp.async`` ring, 8 x 8
register tiles, no products below a diagonal pair's diagonal).
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

# Tile edge, and pixel rows per ring slot of the tensor-core kernels by
# mode (the TF32 kernel's slabs are 64 rows: two K steps a barrier
# round).
_TILE = 64
_ROWS = 32
SLAB_ROWS = {"tf32x3": _ROWS, "tf32": 64}
# Blocks per SM the tensor-core kernels' shared memory and registers
# allow.
_BLOCKS_PER_SM = 2
# Ring slots by mode: the 3xTF32 kernel's 4 of 32 rows, the TF32
# kernel's 2 of 64 (beside its two transposed tiles), or 4 of F_i alone
# where every pair is diagonal (C <= 64).
_STAGES = {"tf32x3": 4, "tf32": 2}
_ALIGN = 1024
# The IEEE kernel (gram_ieee_kernel): 256 threads a block, at most 128
# registers a thread (its launch bounds ask for two blocks an SM), an
# 8 x 8 register tile a thread; 64 x 64 tile pairs, the threads in four
# k-groups of 64 on slabs of 64 rows; a ring of up to 4 slots; the most
# dynamic shared memory a plan may ask for (csrc/gram.cu's
# kIeeeSmemMax).
IEEE_THREADS = 256
IEEE_REGISTERS = 128
IEEE_SLAB = 64
IEEE_KGROUPS = IEEE_THREADS // (_TILE // 8) ** 2
IEEE_MAX_STAGES = 4
IEEE_SMEM_MAX = 112 * 1024
# Up to this many splits form one group, summed in one level; above
# it, two levels of about sqrt(splits) tiles each take less time.
IEEE_ONE_LEVEL = 8
#: An H100's registers and shared memory per SM (1 KB of it reserved
#: for each block).
REGISTERS_PER_SM = 65536
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK_RESERVED = 1024
_STATIC_SMEM = 16  # the kernel's `flag`
# The grid's third dimension, one image per index.
_MAX_BATCH = 65535


@dataclass(frozen=True)
class GramPlan:
    """How ``csrc/gram.cu`` covers one ``(P, C)`` block.

    ``pairs`` 64 x 64 tile pairs on or above the diagonal, ``splits``
    ranges of ``rows`` pixel rows each (a whole
    number of ``slab``-row ring slots), summed in ``groups`` groups of
    ``group``; a ring of ``stages`` slots; ``smem_bytes`` of dynamic
    shared memory; ``kgroups`` groups of threads splitting each slab's
    rows (the IEEE kernel's); ``blocks_per_sm`` blocks an SM
    (the unit the split fills the card in).
    """

    pairs: int
    splits: int
    rows: int
    group: int
    groups: int
    stages: int
    smem_bytes: int
    slab: int = _ROWS
    kgroups: int = 1
    blocks_per_sm: int = _BLOCKS_PER_SM


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


def split_rows(
    p: int, c: int, n_sm: int, slab: int = _ROWS, *,
    blocks_per_sm: int = _BLOCKS_PER_SM,
) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the kernel's split over P.

    Enough splits to give every SM its ``blocks_per_sm`` blocks, each a
    whole number of ``slab``-row slots; the splits cover all ``p``
    rows. Each split has one block per tile pair on or above the
    diagonal.
    """
    side = math.ceil(c / _TILE)
    pairs = side * (side + 1) // 2
    groups = max(1, math.ceil(p / slab))
    cap = max(1, (blocks_per_sm * n_sm) // pairs)
    splits = max(1, min(groups, cap))
    rows = math.ceil(groups / splits) * slab
    return math.ceil(p / rows) if p else 1, rows


def _smem_bytes(mode: Mode) -> int:
    """Dynamic shared memory of a tensor-core mode's kernel: the ring's
    slots (F_i and F_j slabs), the transposed B tiles (hi and lo of one
    slab in ``tf32x3``; two slabs' tiles, double-buffered, in ``tf32``)
    and the mbarriers."""
    rows, stages = SLAB_ROWS[mode], _STAGES[mode]
    slot = 2 * rows * _TILE * 4
    # The TF32 kernel's barriers are sized for its 4 diagonal-only slots.
    bars = 16 * (2 * stages if mode == "tf32" else stages)
    return _ALIGN + stages * slot + 2 * _TILE * rows * 4 + bars


def ieee_smem_bytes(side: int, stages: int) -> int:
    """The IEEE kernel's dynamic shared memory: the most of the ring
    (``stages`` slots of F_i's slab, and F_j's unless ``side`` is 1),
    the k-groups' register tiles and the staged final tile (65 floats a
    row)."""
    slot = (1 if side == 1 else 2) * IEEE_SLAB * _TILE * 4
    return max(
        stages * slot, IEEE_KGROUPS * _TILE * _TILE * 4,
        _TILE * (_TILE + 1) * 4,
    )


def _ieee_plan(p: int, c: int, n_sm: int) -> GramPlan:
    """The IEEE kernel's plan (see :func:`gram_plan`).

    Blocks an SM come from the kernel's own registers
    (``IEEE_REGISTERS`` a thread) and shared memory: the ring takes as
    many slots, up to ``IEEE_MAX_STAGES``, as leave the registers' count
    of blocks room on an SM, and the split over P fills the card in that
    unit. Up to ``IEEE_ONE_LEVEL`` splits form one group, whose sum the
    kernel writes out at once.
    """
    side = math.ceil(c / _TILE)
    by_regs = REGISTERS_PER_SM // (IEEE_REGISTERS * IEEE_THREADS)
    room = (
        SMEM_PER_SM // by_regs - SMEM_PER_BLOCK_RESERVED - _STATIC_SMEM
    )
    slot = (1 if side == 1 else 2) * IEEE_SLAB * _TILE * 4
    stages = min(IEEE_MAX_STAGES, room // slot)
    smem = ieee_smem_bytes(side, stages)
    blocks_per_sm = min(
        by_regs,
        SMEM_PER_SM // (smem + _STATIC_SMEM + SMEM_PER_BLOCK_RESERVED),
    )
    splits, rows = split_rows(
        p, c, n_sm, IEEE_SLAB, blocks_per_sm=blocks_per_sm,
    )
    group = (
        splits if splits <= IEEE_ONE_LEVEL else math.isqrt(splits - 1) + 1
    )
    return GramPlan(
        pairs=side * (side + 1) // 2, splits=splits, rows=rows,
        group=group, groups=math.ceil(splits / group), stages=stages,
        smem_bytes=smem, slab=IEEE_SLAB, kgroups=IEEE_KGROUPS,
        blocks_per_sm=blocks_per_sm,
    )


@functools.cache
def gram_plan(p: int, c: int, n_sm: int, mode: Mode = "tf32x3") -> GramPlan:
    """The kernel's launch plan for a ``(p, c)`` block (``c % 4 == 0``).

    The partial tiles of the splits are summed in groups of ``group``
    (about the square root of ``splits``), then the group sums, so no
    block reads more than about ``2 * sqrt(splits)`` tiles. A batch of
    images is planned image by image, as if each were alone: an image's
    sums run in the same order whatever the batch, so its raw Gram is
    the single launch's, bit for bit. The tensor-core modes share the
    grid and the split's rule; a split's rows are a whole number of the
    mode's slabs (``SLAB_ROWS``), and the ring and the shared memory
    are the mode's. The IEEE mode plans its own slab, ring and blocks
    an SM.
    """
    if mode not in MODES:
        msg = f"gram: unknown mode {mode!r}"
        raise ValueError(msg)
    if mode == "ieee":
        return _ieee_plan(p, c, n_sm)
    side = math.ceil(c / _TILE)
    splits, rows = split_rows(p, c, n_sm, SLAB_ROWS[mode])
    group = math.isqrt(splits - 1) + 1
    stages = _STAGES[mode] * (2 if mode == "tf32" and side == 1 else 1)
    return GramPlan(
        pairs=side * (side + 1) // 2, splits=splits, rows=rows,
        group=group, groups=math.ceil(splits / group),
        stages=stages, smem_bytes=_smem_bytes(mode), slab=SLAB_ROWS[mode],
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
    IEEE kernel's 16-byte copies) is padded with zero channels, which add
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


def gram_raw(
    features: torch.Tensor,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """The raw (C, C) Gram sum of a (B, H, W, C) map: no clamp, no norm.

    A band's Gram partial (``ops/tiled.py``): the bands' raw sums add
    up to the image's, which is then clamped and normalized once. On
    the card it is the kernel's own output in the mode of
    ``gram_precision``, launched with the clamp at ``inf`` and the norm
    at 1, so G equals raw bit for bit. Its backward runs in that same
    mode, as the JAX package's band contraction transposes at its own
    precision (not at ``gram_bwd_precision``). ``features`` must be
    contiguous (a band's valid rows of a single image are): its
    ``(P, C)`` view is free, and nothing is copied.
    """
    if not features.is_contiguous():
        msg = f"gram_raw takes a contiguous feature map: {features.shape}"
        raise ValueError(msg)
    b, h, w, c = features.shape
    mode = kernel_mode(gram_precision(precision))
    flat = features.view(b * h * w, c)
    return _GramFn.apply(flat, math.inf, 1.0, mode, mode)


def gram_raw_batched(
    features: torch.Tensor,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """The raw (S, C, C) Gram sums of an (S, H, W, C) batch, one per
    image: no clamp, no norm.

    :func:`gram_raw` for a batch of images (a dp x sp rank's shard
    partials, one per style): one launch of the batched kernel at
    clamp ``inf`` and norm 1 on the card, each image's partial bit for
    bit as :func:`gram_raw` gives it alone, and a backward of one
    product per image in the forward's mode. ``features`` must be
    contiguous.
    """
    if not features.is_contiguous():
        msg = (
            "gram_raw_batched takes a contiguous feature map: "
            f"{features.shape}"
        )
        raise ValueError(msg)
    s, h, w, c = features.shape
    mode = kernel_mode(gram_precision(precision))
    flat = features.view(s, h * w, c)
    return _GramFn.apply(flat, math.inf, 1.0, mode, mode)


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
