"""3x3 SAME conv + bias + optional ReLU on NHWC, with a frozen backward.

The port of the JAX package's ``ops/pallas_conv.py`` (the Pallas
kernel ``conv3x3_bias_relu`` and its ``precision`` argument) and
``ops/frozen_conv.py`` (the flipped-kernel backward, with its own
``bwd_precision``). On a CUDA tensor the conv runs a hand-written
kernel in the mode of its precision level (``ops/precision.py``):

- ``tf32x3`` and ``tf32``: ``csrc/conv3x3.cu`` on the tensor cores,
  which reads the stencil packed K-major and split into tf32 hi and lo
  halves (``models/vgg19.pack_stencil``; ``tf32`` reads hi only);
- ``ieee``: ``csrc/conv3x3_ieee.cu``, IEEE fp32 on the CUDA cores,
  which reads the unsplit ``(9, C_in, C_out)`` stencil ``w9``.

Every form is made once per layer, when the weights load. A wrapper
launches its mode's kernel or raises; nothing falls back to another
mode or to the plain version. On a CPU tensor the conv runs the plain
version, ``F.conv2d`` on the NCHW permute, in fp32 at every mode (the
tier does not change the CPU path). Any other device raises. Each mode
also has a plain version of its own rounding (:func:`conv3x3_plain`),
which the card's checks hold the kernel against. The tensor-core
kernel's launch plan (tile shape, stages, shared memory, persistent
grid) is :func:`conv_plan`, here in Python where the CPU tests reach
it.

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
#: mode (``launches["ieee"]`` counts ``csrc/conv3x3_ieee.cu``).
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

    An output tile is ``rows x cols`` (= 128) pixels of one image by
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

    mode: Mode
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
    n_sm: int, mode: Mode = "tf32x3",
) -> ConvPlan:
    """The tensor-core kernel's launch plan for an ``(n, h, w, c_in)``
    input in ``mode`` (``tf32x3``, or ``tf32``, whose B slots hold the
    hi box only)."""
    if mode not in ("tf32x3", "tf32"):
        msg = f"conv_plan: {mode!r} is not a tensor-core mode"
        raise ValueError(msg)
    bn = 8 if c_out <= 8 else 64 if c_out <= 64 else 128
    k_pad = -(-9 * c_in // K_STEP) * K_STEP
    halo = c_in % K_STEP == 0
    mask_slab = masked and halo
    b_slot = (2 if mode == "tf32x3" else 1) * bn * K_STEP * 4
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
        mode=mode, bn=bn, rows=rows, cols=cols, k_pad=k_pad, halo=halo,
        mask_slab=mask_slab, slabs=slabs, taps=taps, a_stages=_A_STAGES,
        b_stages=b_stages, a_slot_bytes=a_slot, tiles=tiles, splits=splits,
        split_slabs=split_slabs, blocks=min(tiles * splits, n_sm),
        # Slots, the mbarriers (8 bytes each) and the split-K ticket.
        smem_bytes=(
            _ALIGN + _A_STAGES * a_slot + b_stages * b_slot
            + 16 * (_A_STAGES + b_stages) + 16
        ),
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
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ieee_entry():
    fn = build.load("conv3x3_ieee").conv3x3_ieee_forward
    fn.argtypes = [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 6, ctypes.c_void_p,
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
    n, h, w, c_in = x.shape
    hi = wk[0]
    lo = wk[1] if mode == "tf32x3" else hi
    c_out, k_pad = hi.shape
    plan = conv_plan(
        n, h, w, c_in, c_out, mask is not None,
        build.sm_count(x.device.index), mode,
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
        int(mode == "tf32x3"), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3")
    launches[mode].count += 1
    return out


def _launch_ieee(x, w9, b, apply_relu, mask) -> torch.Tensor:
    """One launch of ``csrc/conv3x3_ieee.cu`` (inputs checked)."""
    n, h, w, c_in = x.shape
    c_out = w9.shape[2]
    out = torch.empty((n, h, w, c_out), device=x.device, dtype=x.dtype)
    status = _ieee_entry()(
        x.data_ptr(), _ptr(mask), w9.data_ptr(), _ptr(b), out.data_ptr(),
        n, h, w, c_in, c_out, int(apply_relu),
        launches["ieee"].slot(x.device).data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3_ieee")
    launches["ieee"].count += 1
    return out


def _conv(x, w9, wk, b, apply_relu, mask, mode: Mode) -> torch.Tensor:
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
        out = _conv(x.contiguous(), w9, wk, b, apply_relu, None, mode)
        ctx.apply_relu = apply_relu
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(out if apply_relu else None, w9_flip, *wk_flip)
        return out

    @staticmethod
    def backward(ctx, g):
        """Image gradient: the flipped conv of ``g`` masked by the ReLU,
        in the backward's mode."""
        out, w9_flip, *wk_flip = ctx.saved_tensors
        dx = _conv(
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
