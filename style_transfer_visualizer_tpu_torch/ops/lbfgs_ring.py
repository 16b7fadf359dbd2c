"""The L-BFGS compact direction's two passes over the curvature ring.

``engine/optimizers._compact_direction`` reads the ring twice: once for
its products (:func:`products_plain`: ``S Y^T``, ``Y Y^T``, ``S g``,
``Y g`` in slot order, fp32, with ``g`` rounded to the ring's type
first) and once for the combination (:func:`combine_plain`: ``d =
-(gamma g + cs S - gamma cy Y)``, the coefficients rounded to the
ring's type first). The JAX package writes both as ``dot_general`` of
the ring with fp32 accumulation and leaves them to XLA; no Pallas
kernel does them.

On the card, with a bf16 ring, each pass is one launch of a hand-written
kernel in ``csrc/lbfgs_ring.cu`` (:func:`products_kernel`,
:func:`combine_kernel`): bf16 tensor-core products with fp32 sums read
the ring as it is stored, with no fp32 copy of it. Each wrapper checks
its inputs and launches its kernel or raises; nothing falls back. The
plain versions are today's arithmetic in PyTorch, the ring upcast to
fp32 ``UPCAST_COLUMNS`` columns at a time: the CPU path and an fp32
ring's (whose upcast copies nothing) on the card, and what the card's
checks hold the kernels against. :func:`on_kernels` says which a
direction takes. The products kernel's launch plan
(:func:`products_plan`) is here in Python, where the CPU tests reach
it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from style_transfer_visualizer_tpu_torch.native import build

#: Runs of both kernels, two a compact direction on the card.
launches = build.LaunchCounter("lbfgs_ring")

#: Ring columns upcast to fp32 at a time by the plain versions: 2 x m x
#: 4,194,304 floats (3.4 GB at m = 100), whatever the image.
UPCAST_COLUMNS = 1 << 22

# csrc/lbfgs_ring.cu: a block tile of 224 rows of [S; Y] by 104 of
# [Y; g], ring columns in stages of 64, and a tile's partial of 23,296
# floats (7 warps x 2 x 13 fragments of 128).
TILE_ROWS = 224
TILE_COLS = 104
STAGE_COLUMNS = 64
FRAG_FLOATS = 7 * 2 * 13 * 128
_ALIGN = 16


def _column_blocks(n: int) -> list[slice]:
    return [slice(lo, min(lo + UPCAST_COLUMNS, n))
            for lo in range(0, n, UPCAST_COLUMNS)]


def products_plain(
    s_hist: torch.Tensor, y_hist: torch.Tensor, grad: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(S Y^T, Y Y^T, S g, Y g)`` of an ``(m, n)`` ring, fp32.

    ``g`` is rounded to the ring's type first. The ring goes to fp32
    ``UPCAST_COLUMNS`` columns at a time, each block's products summed
    in order: a whole fp32 copy (2 x m x n floats, twice the bf16 ring
    itself) would set a large image's peak memory.
    """
    g32 = grad.to(s_hist.dtype).float()
    sums = None
    for cols in _column_blocks(grad.shape[0]):
        s32 = s_hist[:, cols].float()
        y32 = y_hist[:, cols].float()
        part = (s32 @ y32.T, y32 @ y32.T, s32 @ g32[cols], y32 @ g32[cols])
        sums = part if sums is None else tuple(
            a + b for a, b in zip(sums, part, strict=True)
        )
        del s32, y32
    return sums


def combine_plain(
    s_hist: torch.Tensor,
    y_hist: torch.Tensor,
    grad: torch.Tensor,
    coeff_s: torch.Tensor,
    coeff_y: torch.Tensor,
    gamma: torch.Tensor,
) -> torch.Tensor:
    """``-(gamma g + cs S - gamma cy Y)`` with ``cs``, ``cy`` rounded to
    the ring's type, the ring upcast in ``UPCAST_COLUMNS`` blocks."""
    ring_dtype = s_hist.dtype
    coeff_s = coeff_s.to(ring_dtype).float()
    coeff_y = coeff_y.to(ring_dtype).float()
    parts = []
    for cols in _column_blocks(grad.shape[0]):
        s_part = coeff_s @ s_hist[:, cols].float()
        y_part = coeff_y @ y_hist[:, cols].float()
        parts.append(-(gamma * grad[cols] + s_part - gamma * y_part))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def on_kernels(grad: torch.Tensor, ring: torch.Tensor) -> bool:
    """Whether a direction takes the kernels: a CUDA gradient and a
    bf16 ring. A CPU tensor, or an fp32 ring, keeps the plain path."""
    return grad.device.type == "cuda" and ring.dtype == torch.bfloat16


@dataclass(frozen=True)
class ProductsPlan:
    """How ``lbfgs_ring_products_kernel`` covers an ``(m, n)`` ring.

    ``tiles_a`` x ``tiles_b`` block tiles of 224 rows of ``[S; Y]`` by
    104 of ``[Y; g]`` (one where m <= 103); the n columns in ``splits``
    ranges of ``stages_per_split`` 64-column stages; the splits'
    partial tiles summed in ``groups`` groups of ``group``.
    """

    tiles_a: int
    tiles_b: int
    splits: int
    stages_per_split: int
    group: int
    groups: int

    @property
    def tiles(self) -> int:
        """Block tiles, the grid's second dimension."""
        return self.tiles_a * self.tiles_b

    @property
    def workspace_floats(self) -> int:
        """The partial tiles' workspace (none for one split)."""
        if self.splits == 1:
            return 0
        return self.tiles * (self.splits + self.groups) * FRAG_FLOATS

    @property
    def counters(self) -> int:
        """Arrival counters: one a group and one for the groups, a tile."""
        return self.tiles * (self.groups + 1)


@functools.cache
def products_plan(m: int, n: int, n_sm: int) -> ProductsPlan:
    """The products kernel's plan: about one block an SM.

    The columns go to as many splits as leave each tile's blocks one an
    SM, each a whole number of stages; the partials are summed in groups
    of about the square root of ``splits``, so that no block sums more
    than about ``2 sqrt(splits)`` tiles. The plan, and so every bit of
    the result, depends on ``(m, n)`` and the SM count only.
    """
    tiles_a = math.ceil(2 * m / TILE_ROWS)
    tiles_b = math.ceil((m + 1) / TILE_COLS)
    stages = math.ceil(n / STAGE_COLUMNS)
    want = max(1, min(stages, n_sm // (tiles_a * tiles_b)))
    per_split = math.ceil(stages / want)
    splits = math.ceil(stages / per_split)
    group = math.isqrt(splits - 1) + 1
    return ProductsPlan(
        tiles_a=tiles_a, tiles_b=tiles_b, splits=splits,
        stages_per_split=per_split, group=group,
        groups=math.ceil(splits / group),
    )


def _check_ring(
    s_hist: torch.Tensor, y_hist: torch.Tensor, grad: torch.Tensor,
    what: str,
) -> None:
    """Raise unless the ring is two contiguous ``(m, n)`` bf16 tensors
    and ``grad`` a contiguous fp32 ``(n,)``."""
    for name, ring in (("s_hist", s_hist), ("y_hist", y_hist)):
        if ring.dtype != torch.bfloat16:
            msg = f"{what} takes a bfloat16 ring, not {name} {ring.dtype}"
            raise ValueError(msg)
        if ring.dim() != 2 or ring.shape != s_hist.shape:  # noqa: PLR2004
            msg = (
                f"{what}: {name} {tuple(ring.shape)} is not an (m, n) "
                f"ring of s_hist's shape {tuple(s_hist.shape)}"
            )
            raise ValueError(msg)
        if not ring.is_contiguous():
            msg = f"{what} takes a contiguous ring: {name} is not"
            raise ValueError(msg)
    if grad.dtype != torch.float32 or grad.shape != (s_hist.shape[1],):
        msg = (
            f"{what} takes a float32 gradient of shape "
            f"({s_hist.shape[1]},), not {grad.dtype} {tuple(grad.shape)}"
        )
        raise ValueError(msg)
    if not grad.is_contiguous():
        msg = f"{what} takes a contiguous gradient"
        raise ValueError(msg)


def _check_device(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        msg = f"{what} takes CUDA tensors on one device"
        raise ValueError(msg)


def _aligned(n: int, *tensors: torch.Tensor) -> bool:
    """16-byte copies: whole rows of 8 and aligned base pointers."""
    return n % 8 == 0 and all(t.data_ptr() % _ALIGN == 0 for t in tensors)


@functools.cache
def _products_entry():
    fn = build.load("lbfgs_ring").lbfgs_ring_products
    fn.argtypes = [
        *[ctypes.c_void_p] * 6, ctypes.c_longlong, *[ctypes.c_int] * 7,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _combine_entry():
    fn = build.load("lbfgs_ring").lbfgs_ring_combine
    fn.argtypes = [
        *[ctypes.c_void_p] * 7, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def products_kernel(
    s_hist: torch.Tensor, y_hist: torch.Tensor, grad: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`products_plain` in one launch of
    ``lbfgs_ring_products_kernel``, for a bf16 ring on the card.

    The four results are views of one fp32 buffer of ``2 m m + 2 m``.
    """
    what = "lbfgs_ring products kernel"
    _check_ring(s_hist, y_hist, grad, what)
    _check_device(what, grad, s_hist, y_hist)
    m, n = s_hist.shape
    dev = grad.device
    plan = products_plan(m, n, build.sm_count(dev.index))
    mm = m * m
    out = torch.empty(2 * mm + 2 * m, device=dev, dtype=torch.float32)
    # The splits' partial tiles (none for one split).
    ws = torch.empty(plan.workspace_floats, device=dev, dtype=torch.float32)
    counters = build.arrival_counters(dev, plan.counters)
    status = _products_entry()(
        s_hist.data_ptr(), y_hist.data_ptr(), grad.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), n, m,
        plan.tiles_a, plan.tiles_b, plan.splits, plan.stages_per_split,
        plan.group, int(_aligned(n, s_hist, y_hist, grad)),
        launches.slot(dev).data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "lbfgs_ring products")
    launches.count += 1
    return (
        out[:mm].view(m, m), out[mm:2 * mm].view(m, m),
        out[2 * mm:2 * mm + m], out[2 * mm + m:],
    )


def combine_kernel(
    s_hist: torch.Tensor,
    y_hist: torch.Tensor,
    grad: torch.Tensor,
    coeff_s: torch.Tensor,
    coeff_y: torch.Tensor,
    gamma: torch.Tensor,
) -> torch.Tensor:
    """:func:`combine_plain` in one launch of
    ``lbfgs_ring_combine_kernel``, for a bf16 ring on the card.

    ``coeff_s`` and ``coeff_y`` are fp32 ``(m,)`` in slot order (the
    kernel rounds them to bf16); ``gamma`` is one fp32 value on the
    device, read there.
    """
    what = "lbfgs_ring combine kernel"
    _check_ring(s_hist, y_hist, grad, what)
    m, n = s_hist.shape
    for name, t, shape in (
        ("coeff_s", coeff_s, (m,)), ("coeff_y", coeff_y, (m,)),
        ("gamma", gamma, ()),
    ):
        if (t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            msg = (
                f"{what} takes {name} as a contiguous float32 {shape}, "
                f"not {t.dtype} {tuple(t.shape)}"
            )
            raise ValueError(msg)
    _check_device(what, grad, s_hist, y_hist, coeff_s, coeff_y, gamma)
    dev = grad.device
    d = torch.empty_like(grad)
    status = _combine_entry()(
        s_hist.data_ptr(), y_hist.data_ptr(), grad.data_ptr(),
        coeff_s.data_ptr(), coeff_y.data_ptr(), gamma.data_ptr(),
        d.data_ptr(), n, m, int(_aligned(n, s_hist, y_hist, grad, d)),
        launches.slot(dev).data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "lbfgs_ring combine")
    launches.count += 1
    return d
