"""3x3 SAME conv + bias + optional ReLU on NHWC, with a frozen backward.

The port of the JAX package's ``ops/pallas_conv.py`` (the Pallas
kernel ``conv3x3_bias_relu`` and its ``precision`` argument) and
``ops/frozen_conv.py`` (the flipped-kernel backward, with its own
``bwd_precision``). On a CUDA tensor the conv runs a hand-written
kernel in the mode of its precision level (``ops/precision.py``):

- ``tf32x3``: ``csrc/conv3x3.cu`` on the tensor cores, which reads the
  stencil packed K-major and split into tf32 hi and lo halves
  (``models/vgg19.pack_stencil``);
- ``tf32``: ``csrc/conv3x3_tf32.cu`` on the tensor cores, one product a
  K step, which reads the packed hi half only;
- ``ieee``: ``csrc/conv3x3_ieee.cu``, IEEE fp32 on the CUDA cores,
  which reads the unsplit ``(9, C_in, C_out)`` stencil ``w9``.

Every form is made once per layer, when the weights load. A wrapper
launches its mode's kernel or raises; nothing falls back to another
mode or to the plain version. On a CPU tensor the conv runs the plain
version, ``F.conv2d`` on the NCHW permute, in fp32 at every mode (the
tier does not change the CPU path). Any other device raises. Each mode
also has a plain version of its own rounding (:func:`conv3x3_plain`),
which the card's checks hold the kernel against. Each kernel's launch
plan (tile shape, stages, shared memory, grid) is here in Python, where
the CPU tests reach it: the 3xTF32 kernel's :func:`conv_plan`, the TF32
kernel's :func:`tf32_plan`, the IEEE kernel's :func:`ieee_plan`.

The backbone is frozen, so the gradient is for the image only: the
backward runs the same conv on ``g`` with the flipped stencil, no bias,
no ReLU and, when the forward fused its ReLU, the forward's output as a
mask: ``g`` counts only where ``out > 0``. The kernel applies the mask
as it loads ``g``; the plain version with ``torch.where``. Weight and
bias gradients are ``None``; do not differentiate with respect to them.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops.precision import MODES, Mode
from style_transfer_visualizer_tpu_torch.ops.tf32 import (
    round_tf32,
    split_tf32,
)

#: Launches of the conv kernels made by :func:`conv3x3_kernel`, per
#: mode (``launches["ieee"]`` counts ``csrc/conv3x3_ieee.cu``,
#: ``launches["tf32"]`` ``csrc/conv3x3_tf32.cu``).
launches = build.ModeCounters("conv3x3", MODES)

#: Depth of one K step of the kernel (one 128-byte TMA row of float32);
#: the packed stencil's K is padded to a multiple of it.
K_STEP = 32
#: Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
_BM = 128           # output pixels per block
_A_STAGES = 2
_MAX_STAGES = 6
_MIN_SPLIT_STEPS = 4
_ALIGN = 1024       # slot alignment (the 128-byte swizzle's period)

PackedStencil = tuple[torch.Tensor, torch.Tensor]
#: The stencil a mode's kernel reads (:func:`mode_stencil`).
Stencil = tuple[torch.Tensor, ...]


@dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/conv3x3.cu`` covers one conv: tiles, rings, grid.

    The 3xTF32 kernel's plan. An output tile is ``rows x cols`` (=
    128) pixels of one image by
    ``bn`` output channels; there are ``tiles`` of them. A comes in
    ``slabs`` slabs of 32 input channels per tile, each serving ``taps``
    K steps: with ``halo`` (``C_in % 32 == 0``) a slab is the halo'd
    ``(rows + 2) x (cols + 2)`` tile loaded by TMA, used by all nine
    taps, followed by the mask's when ``mask_slab``; without, the
    producer gathers one K step's 128 x 32 slab (masked), ``taps = 1``.
    ``a_stages`` slots of ``a_slot_bytes`` hold the slabs, ``b_stages``
    slots the per-step B boxes (hi and lo). When one image's tiles
    cannot fill the SMs, the slabs are split ``splits`` ways
    (``split_slabs`` each) and the last block to finish a tile sums the
    partials in fixed order. The split is chosen per image, as if the
    batch were 1, so an image's sums run in the same order whatever
    ``n`` is: a batch of images gets, bit for bit, each image's output
    alone (the multi-style batch relies on it). ``blocks`` persistent
    blocks (one per SM at most) walk the ``tiles * splits`` work items.
    """

    bn: int
    rows: int
    cols: int
    k_pad: int
    halo: bool
    mask_slab: bool
    slabs: int
    taps: int
    a_stages: int
    b_stages: int
    a_slot_bytes: int
    tiles: int
    splits: int
    split_slabs: int
    blocks: int
    smem_bytes: int


def _align(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


@functools.cache
def conv_plan(
    n: int, h: int, w: int, c_in: int, c_out: int, masked: bool,
    n_sm: int,
) -> ConvPlan:
    """The 3xTF32 kernel's launch plan for an ``(n, h, w, c_in)``
    input (B slots hold the hi box and the lo box)."""
    bn = 8 if c_out <= 8 else 64 if c_out <= 64 else 128  # noqa: PLR2004
    k_pad = -(-9 * c_in // K_STEP) * K_STEP
    halo = c_in % K_STEP == 0
    mask_slab = masked and halo
    b_slot = 2 * bn * K_STEP * 4
    row_bytes = K_STEP * 4
    # The widest tile whose two A slots leave room for 3 B slots.
    cols = min(_BM, max(8, 1 << (w - 1).bit_length()))
    while True:
        rows = _BM // cols
        slab_rows = (rows + 2) * (cols + 2) if halo else _BM
        a_slot = _align(slab_rows * row_bytes) * (2 if mask_slab else 1)
        room = SMEM_LIMIT - 2 * _ALIGN - _A_STAGES * a_slot
        if room >= 3 * b_slot or cols == 8:
            break
        cols //= 2
    b_stages = min(_MAX_STAGES, room // b_slot)
    slabs = c_in // K_STEP if halo else k_pad // K_STEP
    taps = 9 if halo else 1
    per_image = -(-h // rows) * -(-w // cols) * -(-c_out // bn)
    tiles = n * per_image
    splits = max(
        1, min(n_sm // per_image, slabs * taps // _MIN_SPLIT_STEPS),
    )
    split_slabs = -(-slabs // splits)
    splits = -(-slabs // split_slabs)
    return ConvPlan(
        bn=bn, rows=rows, cols=cols, k_pad=k_pad, halo=halo,
        mask_slab=mask_slab, slabs=slabs, taps=taps, a_stages=_A_STAGES,
        b_stages=b_stages, a_slot_bytes=a_slot, tiles=tiles, splits=splits,
        split_slabs=split_slabs, blocks=min(tiles * splits, n_sm),
        # Slots, the mbarriers (8 bytes each) and the split-K ticket.
        smem_bytes=(
            _ALIGN + _A_STAGES * a_slot + b_stages * b_slot
            + 16 * (_A_STAGES + b_stages) + 16
        ),
    )


#: The TF32 kernel's most B stages, and its A stages with a halo'd slab
#: (one loading while the other serves its nine taps) and with a
#: gathered one (gathers are slow to land, so more run ahead).
TF32_MAX_B_STAGES = 6
TF32_HALO_A_STAGES = 2
TF32_GATHER_A_STAGES = 4
#: Threads of the TF32 kernel's producer warpgroup that prepare A.
TF32_PREPARERS = 96
_BAR = 8            # bytes of an mbarrier


@dataclass(frozen=True)
class Tf32Plan:
    """How ``csrc/conv3x3_tf32.cu`` covers one conv.

    An output tile is ``rows x cols`` (= ``bm`` = 128 * ``wm``) pixels
    of one image by ``bn`` output channels; each of the two consumer
    warpgroups owns ``wm`` 64-pixel sub-tiles; there are ``tiles``
    tiles. A comes in ``slabs`` slabs of 32 input channels per tile,
    each serving ``taps`` K steps of 32: with ``halo`` (``C_in % 32 ==
    0``) a slab is the halo'd ``(rows + 2) x (cols + 2)`` tile by TMA
    (``slab_rows`` pixel rows, pitch ``cols + 2``), used by all nine
    taps, with the mask's same box in one buffer beside the ring when
    ``mask_slab``; without, the producer's preparers gather one K step's
    ``bm x 32`` slab, ``taps = 1``. Either way the slab is rounded to
    tf32 and masked once. ``ss``: every tap reads A through descriptors
    at its row offset (each sub-tile one run of slab rows: ``cols ==
    64``, or a gathered slab); else A is read into registers (``wm =
    1``). ``a_stages`` slots of ``a_slot_bytes`` hold the slabs,
    ``b_stages`` slots one 32 x ``bn`` B box each. K is split per image
    ``splits`` ways (``split_slabs`` slabs each) when one image's tiles
    cannot fill the SMs; the last block of a tile sums the partials in
    split order, so a batch gets each image's output alone, bit for
    bit. ``blocks`` persistent blocks (one per SM at most) walk the
    ``tiles * splits`` work items.
    """

    bn: int
    wm: int
    ss: bool
    rows: int
    cols: int
    k_pad: int
    halo: bool
    mask_slab: bool
    slabs: int
    taps: int
    slab_rows: int
    a_stages: int
    b_stages: int
    a_slot_bytes: int
    tiles: int
    splits: int
    split_slabs: int
    blocks: int
    smem_bytes: int

    @property
    def bm(self) -> int:
        """Output pixels of a tile."""
        return 128 * self.wm

    @property
    def pitch(self) -> int:
        """Slab rows between two pixel rows of a halo'd slab."""
        return self.cols + 2


def _splits(per_image: int, k_steps: int, n_sm: int) -> int:
    """Ways to split K: enough work items to fill ``n_sm`` SMs, each of
    at least ``_MIN_SPLIT_STEPS`` K steps."""
    return max(1, min(n_sm // per_image, k_steps // _MIN_SPLIT_STEPS))


@functools.cache
def tf32_plan(
    n: int, h: int, w: int, c_in: int, c_out: int, masked: bool,
    n_sm: int, wm: int | None = None,
) -> Tf32Plan:
    """The TF32 kernel's launch plan for an ``(n, h, w, c_in)`` input and
    ``c_out`` outputs. Tiles are 64 pixels wide (narrower images: the
    image's power of two). ``wm`` (sub-tiles a warpgroup) is 2, a
    256-pixel tile whose B boxes serve twice the pixels, wherever A is
    read through descriptors, unless 128-pixel tiles fill the card
    without the split over K that 256-pixel ones need; it may be forced.
    The tile depends on the image and the channels only, and the split
    not on ``n``."""
    bn = 8 if c_out <= 8 else 64 if c_out <= 64 else 128  # noqa: PLR2004
    k_pad = -(-9 * c_in // K_STEP) * K_STEP
    halo = c_in % K_STEP == 0
    cols = min(64, max(8, 1 << (w - 1).bit_length()))
    ss = not halo or cols == 64  # noqa: PLR2004
    slabs = c_in // K_STEP if halo else k_pad // K_STEP
    taps = 9 if halo else 1

    def per_image(m: int) -> int:
        return -(-h // (_BM * m // cols)) * -(-w // cols) * -(-c_out // bn)

    if wm is None:
        k_steps = slabs * taps
        wm = 2 if ss else 1
        if ss and _splits(per_image(1), k_steps, n_sm) == 1 < _splits(
            per_image(2), k_steps, n_sm,
        ):
            wm = 1
    if wm not in (1, 2) or (not ss and wm != 1):
        msg = f"tf32_plan: no kernel for wm={wm} with ss={ss}"
        raise ValueError(msg)
    rows = _BM * wm // cols
    slab_rows = (rows + 2) * (cols + 2) if halo else _BM * wm
    a_slot = _align(slab_rows * K_STEP * 4)
    mask_slab = masked and halo
    a_stages = TF32_HALO_A_STAGES if halo else TF32_GATHER_A_STAGES
    b_slot = bn * K_STEP * 4
    fixed = (
        _ALIGN + (a_stages + mask_slab) * a_slot
        + _BAR * (3 * a_stages + 2) + 16
    )
    b_stages = min(
        TF32_MAX_B_STAGES, (SMEM_LIMIT - fixed) // (b_slot + 2 * _BAR),
    )
    if b_stages < 3:  # noqa: PLR2004
        msg = f"tf32_plan: a {rows}x{cols} slab leaves no B ring"
        raise ValueError(msg)
    splits = _splits(per_image(wm), slabs * taps, n_sm)
    split_slabs = -(-slabs // splits)
    splits = -(-slabs // split_slabs)
    tiles = n * per_image(wm)
    return Tf32Plan(
        bn=bn, wm=wm, ss=ss, rows=rows, cols=cols, k_pad=k_pad, halo=halo,
        mask_slab=mask_slab, slabs=slabs, taps=taps, slab_rows=slab_rows,
        a_stages=a_stages, b_stages=b_stages, a_slot_bytes=a_slot,
        tiles=tiles, splits=splits, split_slabs=split_slabs,
        blocks=min(tiles * splits, n_sm),
        # Slots, the mask buffer, the barriers and the split-K ticket.
        smem_bytes=fixed + b_stages * (b_slot + 2 * _BAR),
    )


#: Channel slots of one K chunk of the IEEE kernel (two quads of 4).
IEEE_BK = 8
#: The IEEE kernel's block shapes: output channels -> threads; a thread
#: holds 8 pixels by 8 channels, so a block covers threads * 64 / bn
#: pixels.
IEEE_BLOCKS = {128: 256, 64: 256, 8: 128}
_IEEE_MAX_STAGES = 3
_IEEE_MIN_SPLIT_CHUNKS = 4


@dataclass(frozen=True)
class IeeePlan:
    """How ``csrc/conv3x3_ieee.cu`` covers one conv.

    A block computes ``rows x cols`` (= ``bm``) pixels of one image by
    ``bn`` output channels with ``threads`` threads; there are ``tiles``
    such tiles. K comes in ``chunks`` chunks of ``4 * quads`` input
    channels (``quads`` = 2, or 1 for ``C_in <= 4``: conv 0's three
    channels run 36 K steps, 27 of them real), zero beyond ``C_in``;
    a chunk's A is the ``(rows + 2) x (cols + 2)`` halo'd slab, which
    serves all nine taps. A stage of the ring holds, in floats, A as
    ``[quads][slab_px][4]`` (channel quads of ``slab_px`` pixels), the
    mask's slab at ``mask_off`` when masked, and B as ``[9 *
    IEEE_BK][bn]`` at ``b_off``; ``stages`` stages of ``stage_floats``.
    When one image's tiles cannot fill the SMs, K is split ``splits``
    ways (``split_chunks`` chunks each), chosen per image as if the
    batch were 1, and the last block of a tile sums the partials in
    split order: each image of a batch gets its output alone, bit for
    bit. One block per work item: ``blocks = tiles * splits``.
    """

    bn: int
    threads: int
    bm: int
    rows: int
    cols: int
    quads: int
    chunks: int
    slab_px: int
    stages: int
    stage_floats: int
    mask_off: int
    b_off: int
    tiles: int
    splits: int
    split_chunks: int
    blocks: int
    smem_bytes: int


@functools.cache
def ieee_plan(
    n: int, h: int, w: int, c_in: int, c_out: int, masked: bool, n_sm: int,
) -> IeeePlan:
    """The IEEE fp32 kernel's launch plan for an ``(n, h, w, c_in)``
    input and ``c_out`` outputs; raises if no ring of two stages fits."""
    bn = 8 if c_out <= 8 else 64 if c_out <= 64 else 128  # noqa: PLR2004
    threads = IEEE_BLOCKS[bn]
    bm = threads * 64 // bn
    # A rectangle about square, cols >= rows, no wider than the image
    # needs; at most 64 rows, so the slab stays within the ring.
    square = 1 << -(-(bm.bit_length() - 1) // 2)
    cols = max(min(square, 1 << (w - 1).bit_length()), bm // 64)
    rows = bm // cols
    quads = min(IEEE_BK // 4, -(-c_in // 4))
    chunks = -(-c_in // (4 * quads))
    slab_px = -(-(rows + 2) * (cols + 2) // 8) * 8
    a_floats = 4 * quads * slab_px
    mask_off = a_floats
    b_off = a_floats * (2 if masked else 1)
    stage_floats = -(-(b_off + 9 * IEEE_BK * bn) // 32) * 32
    stages = min(_IEEE_MAX_STAGES, (SMEM_LIMIT - 16) // (4 * stage_floats))
    if stages < 2:  # noqa: PLR2004
        msg = (
            f"ieee_plan: a {rows}x{cols} tile's stage ({4 * stage_floats} "
            "bytes) leaves no ring of two in shared memory"
        )
        raise ValueError(msg)
    per_image = -(-h // rows) * -(-w // cols) * -(-c_out // bn)
    splits = max(
        1, min(n_sm // per_image, chunks // _IEEE_MIN_SPLIT_CHUNKS),
    )
    split_chunks = -(-chunks // splits)
    splits = -(-chunks // split_chunks)
    tiles = n * per_image
    return IeeePlan(
        bn=bn, threads=threads, bm=bm, rows=rows, cols=cols, quads=quads,
        chunks=chunks, slab_px=slab_px, stages=stages,
        stage_floats=stage_floats, mask_off=mask_off, b_off=b_off,
        tiles=tiles, splits=splits, split_chunks=split_chunks,
        blocks=tiles * splits,
        # The ring, then the split-K ticket.
        smem_bytes=stages * stage_floats * 4 + 16,
    )


def _conv2d(
    x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor | None = None,
) -> torch.Tensor:
    """The SAME conv of NHWC ``x`` with a ``(9, C_in, C_out)`` stencil
    and bias ``b``, NCHW out."""
    _, c_in, c_out = w9.shape
    w_oihw = w9.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)


def conv3x3_plain(
    x: torch.Tensor,
    w9: torch.Tensor,
    b: torch.Tensor | None,
    apply_relu: bool,
    mask: torch.Tensor | None = None,
    mode: Mode = "ieee",
) -> torch.Tensor:
    """A mode's kernel function in plain PyTorch (``F.conv2d``).

    ``x`` is ``(N, H, W, C_in)``, ``w9`` the ``(9, C_in, C_out)``
    stencil, ``b`` the ``(C_out,)`` bias or ``None``; ``x`` counts only
    where ``mask`` (same shape) is ``> 0`` when a mask is given. The
    products are the mode's: ``ieee`` the fp32 conv; ``tf32`` the fp32
    conv of tf32-rounded operands (each product exact in fp32);
    ``tf32x3`` the three convs of the split halves, ``lo*hi + hi*lo +
    hi*hi``. Run it with cuDNN's TF32 off on the card
    (``torch.backends.cudnn.allow_tf32``), or the fp32 convs round.
    """
    if mask is not None:
        x = torch.where(mask > 0, x, 0.0)
    if mode == "ieee":
        out = _conv2d(x, w9, b)
    else:
        if mode == "tf32":
            out = _conv2d(round_tf32(x), round_tf32(w9))
        elif mode == "tf32x3":
            (x_hi, x_lo), (w_hi, w_lo) = split_tf32(x), split_tf32(w9)
            out = (
                _conv2d(x_lo, w_hi) + _conv2d(x_hi, w_lo)
            ) + _conv2d(x_hi, w_hi)
        else:
            msg = f"conv3x3: unknown mode {mode!r}"
            raise ValueError(msg)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
    out = out.permute(0, 2, 3, 1).contiguous()
    return torch.relu(out) if apply_relu else out


def mode_stencil(mode: Mode, w9: torch.Tensor, wk: PackedStencil) -> Stencil:
    """The stencil ``mode``'s kernel reads: ``(w9,)`` for ``ieee``,
    ``(hi,)`` for ``tf32``, ``(hi, lo)`` for ``tf32x3``; ``wk`` is
    ``pack_stencil(w9)``."""
    if mode == "ieee":
        return (w9,)
    if mode == "tf32":
        return (wk[0],)
    if mode == "tf32x3":
        return tuple(wk)
    msg = f"conv3x3: unknown mode {mode!r}"
    raise ValueError(msg)


@functools.cache
def _entry():
    fn = build.load("conv3x3").conv3x3_forward
    fn.argtypes = [
        *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 20, *[ctypes.c_void_p] * 3,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tf32_entry():
    fn = build.load("conv3x3_tf32").conv3x3_tf32_forward
    fn.argtypes = [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 22, *[ctypes.c_void_p] * 3,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ieee_entry():
    fn = build.load("conv3x3_ieee").conv3x3_ieee_forward
    fn.argtypes = [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 21, *[ctypes.c_void_p] * 3,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(
    x: torch.Tensor,
    wk: Stencil,
    b: torch.Tensor | None,
    mask: torch.Tensor | None,
    mode: Mode,
) -> None:
    tensors = [x, *wk, *(t for t in (b, mask) if t is not None)]
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            msg = "conv3x3 kernel takes float32 CUDA tensors"
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = "conv3x3 kernel takes contiguous tensors"
            raise ValueError(msg)
    need = 2 if mode == "tf32x3" else 1
    if x.dim() != 4 or len(wk) < need:
        msg = f"conv3x3: bad shapes x {tuple(x.shape)} for mode {mode}"
        raise ValueError(msg)
    c_in = x.shape[3]
    w = wk[0]
    if mode == "ieee":
        if w.dim() != 3 or w.shape[:2] != (9, c_in):  # noqa: PLR2004
            msg = f"conv3x3: stencil {tuple(w.shape)} does not fit C_in {c_in}"
            raise ValueError(msg)
        c_out = w.shape[2]
    else:
        if w.dim() != 2 or any(t.shape != w.shape for t in wk[:need]):
            msg = f"conv3x3: bad shapes x {tuple(x.shape)} wk {tuple(w.shape)}"
            raise ValueError(msg)
        if w.shape[1] != -(-9 * c_in // K_STEP) * K_STEP:
            msg = f"conv3x3: packed K {w.shape[1]} does not fit C_in {c_in}"
            raise ValueError(msg)
        c_out = w.shape[0]
    if b is not None and b.shape != (c_out,):
        msg = f"conv3x3: bias shape {tuple(b.shape)} != ({c_out},)"
        raise ValueError(msg)
    if mask is not None and mask.shape != x.shape:
        msg = f"conv3x3: mask shape {tuple(mask.shape)} != {tuple(x.shape)}"
        raise ValueError(msg)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def conv3x3_kernel(
    x: torch.Tensor,
    wk: Stencil,
    b: torch.Tensor | None,
    apply_relu: bool,
    mask: torch.Tensor | None = None,
    mode: Mode = "tf32x3",
) -> torch.Tensor:
    """Launch ``mode``'s conv kernel on CUDA tensors (no autograd).

    ``wk`` is the stencil the mode reads (:func:`mode_stencil`): the
    packed ``(hi, lo)`` of ``models.vgg19.pack_stencil`` for
    ``tf32x3``, its ``hi`` (the pair is taken too) for ``tf32``,
    ``(w9,)`` for ``ieee``; ``mask`` as in :func:`conv3x3_plain`. An
    unknown mode raises.
    """
    if mode not in MODES:
        msg = f"conv3x3: unknown mode {mode!r}"
        raise ValueError(msg)
    _check_inputs(x, wk, b, mask, mode)
    if mode == "ieee":
        return _launch_ieee(x, wk[0], b, apply_relu, mask)
    if mode == "tf32":
        return _launch_tf32(x, wk[0], b, apply_relu, mask)
    n, h, w, c_in = x.shape
    hi, lo = wk[:2]
    c_out, k_pad = hi.shape
    plan = conv_plan(
        n, h, w, c_in, c_out, mask is not None,
        build.sm_count(x.device.index),
    )
    out = torch.empty((n, h, w, c_out), device=x.device, dtype=x.dtype)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(
            plan.tiles * plan.splits * _BM * plan.bn, device=x.device,
            dtype=x.dtype,
        )
        counters = build.arrival_counters(x.device, plan.tiles)
    status = _entry()(
        x.data_ptr(), _ptr(mask), hi.data_ptr(), lo.data_ptr(), _ptr(b),
        out.data_ptr(), n, h, w, c_in, c_out, k_pad, int(apply_relu),
        plan.bn, plan.rows, plan.cols, int(plan.halo), plan.slabs,
        plan.taps, plan.a_stages, plan.b_stages, plan.a_slot_bytes,
        plan.splits, plan.split_slabs, plan.blocks, plan.smem_bytes,
        _ptr(ws), _ptr(counters), launches[mode].slot(x.device).data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3")
    launches[mode].count += 1
    return out


def _launch_tf32(x, hi, b, apply_relu, mask) -> torch.Tensor:
    """One launch of ``csrc/conv3x3_tf32.cu`` on its :func:`tf32_plan`
    (inputs checked)."""
    n, h, w, c_in = x.shape
    c_out, k_pad = hi.shape
    plan = tf32_plan(
        n, h, w, c_in, c_out, mask is not None,
        build.sm_count(x.device.index),
    )
    out = torch.empty((n, h, w, c_out), device=x.device, dtype=x.dtype)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(
            plan.tiles * plan.splits * plan.bm * plan.bn, device=x.device,
            dtype=x.dtype,
        )
        counters = build.arrival_counters(x.device, plan.tiles)
    status = _tf32_entry()(
        x.data_ptr(), _ptr(mask), hi.data_ptr(), _ptr(b), out.data_ptr(),
        n, h, w, c_in, c_out, k_pad, int(apply_relu), plan.bn, plan.wm,
        int(plan.ss), plan.rows, plan.cols, int(plan.halo), plan.slabs,
        plan.taps, plan.a_stages, plan.b_stages, plan.a_slot_bytes,
        plan.splits, plan.split_slabs, plan.blocks, plan.smem_bytes,
        _ptr(ws), _ptr(counters), launches["tf32"].slot(x.device).data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3_tf32")
    launches["tf32"].count += 1
    return out


def _launch_ieee(x, w9, b, apply_relu, mask) -> torch.Tensor:
    """One launch of ``csrc/conv3x3_ieee.cu`` on its :func:`ieee_plan`
    (inputs checked)."""
    n, h, w, c_in = x.shape
    c_out = w9.shape[2]
    plan = ieee_plan(
        n, h, w, c_in, c_out, mask is not None,
        build.sm_count(x.device.index),
    )
    out = torch.empty((n, h, w, c_out), device=x.device, dtype=x.dtype)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(
            plan.blocks * plan.bm * plan.bn, device=x.device, dtype=x.dtype,
        )
        counters = build.arrival_counters(x.device, plan.tiles)
    status = _ieee_entry()(
        x.data_ptr(), _ptr(mask), w9.data_ptr(), _ptr(b), out.data_ptr(),
        n, h, w, c_in, c_out, int(apply_relu), plan.bn, plan.threads,
        plan.rows, plan.cols, plan.quads, plan.chunks, plan.slab_px,
        plan.stages, plan.stage_floats, plan.mask_off,
        plan.b_off, plan.splits, plan.split_chunks, plan.blocks,
        plan.smem_bytes, _ptr(ws), _ptr(counters),
        launches["ieee"].slot(x.device).data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3_ieee")
    launches["ieee"].count += 1
    return out


def conv3x3_apply(
    x: torch.Tensor,
    w9: torch.Tensor,
    wk: PackedStencil,
    b: torch.Tensor | None,
    apply_relu: bool,
    mask: torch.Tensor | None,
    mode: Mode,
) -> torch.Tensor:
    """One conv without autograd, by the tensor's device: ``mode``'s
    kernel on a CUDA tensor (:func:`conv3x3_kernel` on the stencil the
    mode reads), the plain version on a CPU one; any other device
    raises. ``w9`` and its packed halves ``wk`` as in
    :func:`conv3x3_bias_relu`."""
    if x.device.type == "cuda":
        return conv3x3_kernel(
            x, mode_stencil(mode, w9, wk), b, apply_relu, mask, mode,
        )
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, b, apply_relu, mask)
    msg = f"conv3x3 runs on CUDA or CPU tensors, not {x.device}"
    raise ValueError(msg)


class _Conv3x3Fn(torch.autograd.Function):
    @staticmethod
    def forward(
        ctx, x, w9, w9_flip, b, apply_relu, wk, wk_flip, mode, bwd_mode,
    ):
        """Run the conv in ``mode``; keep the output when the ReLU is
        fused."""
        out = conv3x3_apply(
            x.contiguous(), w9, wk, b, apply_relu, None, mode,
        )
        ctx.apply_relu = apply_relu
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(out if apply_relu else None, w9_flip, *wk_flip)
        return out

    @staticmethod
    def backward(ctx, g):
        """Image gradient: the flipped conv of ``g`` masked by the ReLU,
        in the backward's mode."""
        out, w9_flip, *wk_flip = ctx.saved_tensors
        dx = conv3x3_apply(
            g.contiguous(), w9_flip, tuple(wk_flip), None, False,
            out if ctx.apply_relu else None, ctx.bwd_mode,
        )
        return dx, None, None, None, None, None, None, None, None


def conv3x3_bias_relu(
    x: torch.Tensor,
    w9: torch.Tensor,
    w9_flip: torch.Tensor,
    b: torch.Tensor,
    apply_relu: bool,
    wk: PackedStencil,
    wk_flip: PackedStencil,
    mode: Mode = "tf32x3",
    bwd_mode: Mode | None = None,
) -> torch.Tensor:
    """``relu?(conv3x3_same(x, w) + b)`` on ``(N, H, W, C_in)``.

    ``w9_flip`` must be ``models.vgg19.flip_stencil(w9)``, and ``wk`` and
    ``wk_flip`` the packed halves of ``w9`` and ``w9_flip``
    (``models.vgg19.pack_stencil``); each mode's kernel reads its form
    (:func:`mode_stencil`), the plain version ``w9`` and ``w9_flip``.
    The forward runs in ``mode``, the image gradient, the conv of the
    (masked) output gradient with the flipped stencil, in ``bwd_mode``
    (``None``: ``mode``), as the JAX package's ``precision`` and
    ``bwd_precision``.
    """
    for m in (mode, bwd_mode):
        if m is not None and m not in MODES:
            msg = f"conv3x3: unknown mode {m!r}"
            raise ValueError(msg)
    return _Conv3x3Fn.apply(
        x, w9, w9_flip, b, apply_relu, wk, wk_flip, mode,
        mode if bwd_mode is None else bwd_mode,
    )
