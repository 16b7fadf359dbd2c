"""The TF32 rounding and the 3xTF32 split, as the kernels compute them.

The CUDA kernels (``csrc/tf32x3.cuh``) split each float32 operand ``a``
into ``hi = tf32(a)`` and ``lo = tf32(a - hi)``, both rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and sum
``hi*hi + hi*lo + lo*hi`` on the tensor cores (3xTF32, the ``high``
tier); in TF32 (``default``) they take the one product ``hi*hi``.
TF32 keeps float32's exponent and the top 10 bits of its mantissa; here
the rounding is done on the bit pattern. The packed stencils are split
with it once, when the weights are loaded (``models/vgg19.py``); the
plain versions of the modes (``ops/conv3x3.py``, ``ops/gram.py``) and
the ``default`` tier's Gram backward on the card round with it.
"""
from __future__ import annotations

import torch

_HALF_ULP = 0x1000   # half of TF32's last bit, in float32 bits
_KEEP = -0x2000      # 0xFFFFE000: sign, exponent and 10 mantissa bits


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (nearest, ties away), as float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + _HALF_ULP) & _KEEP).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(t)`` and ``lo = tf32(t - hi)``."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)
