"""3x3 SAME conv + bias + optional ReLU on NHWC, with a frozen backward.

The port of the JAX package's ``ops/pallas_conv.py`` (the Pallas
kernel ``conv3x3_bias_relu``) and ``ops/frozen_conv.py`` (the
flipped-kernel backward). On a CUDA tensor the conv runs the
hand-written kernel ``csrc/conv3x3.cu``; on a CPU tensor it runs the
plain version, ``F.conv2d`` on the NCHW permute. Any other device
raises: a CUDA tensor never takes the plain version.

The backbone is frozen, so the gradient is for the image only: the
backward masks ``g`` by ``out > 0`` when the ReLU was fused and runs
the same conv with the flipped stencil, no bias and no ReLU. Weight and
bias gradients are ``None``; do not differentiate with respect to them.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.native import build

#: Launches of ``csrc/conv3x3.cu`` made by :func:`conv3x3_kernel`.
launches = build.LaunchCounter("conv3x3")


def conv3x3_plain(
    x: torch.Tensor,
    w9: torch.Tensor,
    b: torch.Tensor | None,
    apply_relu: bool,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``F.conv2d``).

    ``x`` is ``(N, H, W, C_in)``, ``w9`` the ``(9, C_in, C_out)``
    stencil, ``b`` the ``(C_out,)`` bias or ``None``.
    """
    _, c_in, c_out = w9.shape
    w_oihw = w9.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    out = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)
    out = out.permute(0, 2, 3, 1).contiguous()
    return torch.relu(out) if apply_relu else out


@functools.cache
def _entry():
    fn = build.load("conv3x3").conv3x3_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(
    x: torch.Tensor,
    w9: torch.Tensor,
    b: torch.Tensor | None,
) -> None:
    tensors = [x, w9] if b is None else [x, w9, b]
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            msg = "conv3x3 kernel takes float32 CUDA tensors"
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = "conv3x3 kernel takes contiguous tensors"
            raise ValueError(msg)
    if x.dim() != 4 or w9.dim() != 3 or w9.shape[0] != 9:
        msg = f"conv3x3: bad shapes x {tuple(x.shape)} w9 {tuple(w9.shape)}"
        raise ValueError(msg)
    if w9.shape[1] != x.shape[3]:
        msg = f"conv3x3: C_in {x.shape[3]} != stencil's {w9.shape[1]}"
        raise ValueError(msg)
    if b is not None and b.shape != (w9.shape[2],):
        msg = f"conv3x3: bias shape {tuple(b.shape)} != ({w9.shape[2]},)"
        raise ValueError(msg)


def conv3x3_kernel(
    x: torch.Tensor,
    w9: torch.Tensor,
    b: torch.Tensor | None,
    apply_relu: bool,
) -> torch.Tensor:
    """Launch ``csrc/conv3x3.cu`` on CUDA tensors (no autograd)."""
    _check_inputs(x, w9, b)
    n, h, w, c_in = x.shape
    c_out = w9.shape[2]
    out = torch.empty((n, h, w, c_out), device=x.device, dtype=x.dtype)
    status = _entry()(
        x.data_ptr(), w9.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), n, h, w, c_in, c_out, int(apply_relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "conv3x3")
    launches.count += 1
    return out


def _conv(
    x: torch.Tensor,
    w9: torch.Tensor,
    b: torch.Tensor | None,
    apply_relu: bool,
) -> torch.Tensor:
    if x.device.type == "cuda":
        return conv3x3_kernel(x, w9, b, apply_relu)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, b, apply_relu)
    msg = f"conv3x3 runs on CUDA or CPU tensors, not {x.device}"
    raise ValueError(msg)


class _Conv3x3Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w9, w9_flip, b, apply_relu):
        """Run the conv; keep the output when the ReLU is fused."""
        out = _conv(x.contiguous(), w9, b, apply_relu)
        ctx.apply_relu = apply_relu
        ctx.save_for_backward(out if apply_relu else None, w9_flip)
        return out

    @staticmethod
    def backward(ctx, g):
        """Image gradient: the flipped conv of the masked ``g``."""
        out, w9_flip = ctx.saved_tensors
        g = g.contiguous()
        if ctx.apply_relu:
            g = g * (out > 0).to(g.dtype)
        dx = _conv(g, w9_flip, None, False)
        return dx, None, None, None, None


def conv3x3_bias_relu(
    x: torch.Tensor,
    w9: torch.Tensor,
    w9_flip: torch.Tensor,
    b: torch.Tensor,
    apply_relu: bool,
) -> torch.Tensor:
    """``relu?(conv3x3_same(x, w) + b)`` on ``(N, H, W, C_in)``.

    ``w9_flip`` must be ``models.vgg19.flip_stencil(w9)``; the image
    gradient is the conv of the (masked) output gradient with it.
    """
    return _Conv3x3Fn.apply(x, w9, w9_flip, b, apply_relu)
