"""The 3xTF32 arithmetic, the packed stencils and the launch plans.

The kernels run only on the card; what they compute is fixed here on
the CPU: the tf32 split (bit-masked in torch, as ``csrc/tf32x3.cuh``
does it), the K-major packing of the stencils, a test-side emulation of
3xTF32 at small conv and Gram shapes (it must stay within 1e-5 of
float32, the tolerance this fixes before any chip run), the launch
plans at every main-path shape of ``chip_smoke.py``, and the fused ReLU
mask of the backward against the JAX VJP.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from style_transfer_visualizer_tpu.ops.pallas_conv import (
    conv3x3_bias_relu as jax_conv,
    hwio_to_stencil,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    pack_stencil,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram
from style_transfer_visualizer_tpu_torch.ops.tf32 import (
    round_tf32,
    split_tf32,
)

EMULATION_RTOL = 1e-5
N_SM = 132  # the H100 SXM's
LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def _randn(seed: int, *shape: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    draw = rng.normal(size=shape) * scale
    return torch.from_numpy(draw.astype(np.float32))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize(
    ("value", "expected"),
    [
        (1.0 + 2.0**-11, 1.0 + 2.0**-10),      # a tie rounds away from 0
        (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
        (1.0 + 2.0**-12, 1.0),                 # below half: down
        (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),  # above half: up
        (0.0, 0.0),
    ],
)
def test_round_tf32_is_nearest_ties_away(value, expected) -> None:
    assert round_tf32(torch.tensor([value])).item() == expected


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e6, 1e30])
def test_split_reconstructs_float32(scale) -> None:
    t = _randn(0, 4096, scale=scale)
    hi, lo = split_tf32(t)
    assert not bool((_bits(hi) & LOW_BITS).any())
    assert not bool((_bits(lo) & LOW_BITS).any())
    rel = ((hi.double() + lo.double()) - t.double()).abs() / t.double().abs()
    assert float(rel.max()) <= 2.0**-21


@pytest.mark.parametrize(("c_in", "c_out"), [(3, 64), (64, 3), (17, 70)])
def test_packed_stencils_index_back_to_w9(c_in, c_out) -> None:
    w9 = _randn(1, 9, c_in, c_out, scale=0.1)
    for stencil in (w9, flip_stencil(w9)):
        hi, lo = pack_stencil(stencil)
        k_in, rows = stencil.shape[1], stencil.shape[2]
        k_pad = conv3x3.conv_plan(1, 8, 8, k_in, rows, False, N_SM).k_pad
        assert hi.shape == lo.shape == (rows, k_pad)
        assert k_pad % conv3x3.K_STEP == 0
        assert not bool(hi[:, 9 * k_in:].any())
        assert not bool(lo[:, 9 * k_in:].any())
        back = (hi + lo)[:, : 9 * k_in].T.reshape(9, k_in, rows)
        torch.testing.assert_close(back, stencil, rtol=2.0**-21, atol=0)
        torch.testing.assert_close(
            hi[:, : 9 * k_in], round_tf32(stencil.reshape(9 * k_in, rows).T),
            rtol=0, atol=0,
        )


def _conv_terms(x, w9) -> torch.Tensor:
    """3xTF32 of the conv, each product exact in float64."""
    x_hi, x_lo = (t.double() for t in split_tf32(x))
    w_hi, w_lo = (t.double() for t in split_tf32(w9))
    return sum(
        conv3x3.conv3x3_plain(a, b, None, False)
        for a, b in ((x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi))
    )


@pytest.mark.parametrize(
    ("h", "w", "c_in", "c_out"), [(9, 13, 3, 64), (8, 8, 64, 32)],
)
def test_emulated_3xtf32_conv_within_1e5_of_float32(h, w, c_in, c_out):
    x = _randn(2, 1, h, w, c_in)
    w9 = _randn(3, 9, c_in, c_out, scale=(2.0 / (9 * c_in)) ** 0.5)
    ref = conv3x3.conv3x3_plain(x, w9, None, False)
    err = (_conv_terms(x, w9) - ref.double()).abs().max()
    assert float(err) <= EMULATION_RTOL * float(ref.abs().max())


@pytest.mark.parametrize(("p", "c"), [(1000, 64), (256, 130)])
def test_emulated_3xtf32_gram_within_1e5_of_float32(p, c) -> None:
    f = _randn(4, p, c, scale=3.0)
    f_hi, f_lo = (t.double() for t in split_tf32(f))
    emulated = f_hi.T @ f_hi + f_hi.T @ f_lo + f_lo.T @ f_hi
    ref = f.T @ f
    err = (emulated - ref.double()).abs().max()
    assert float(err) <= EMULATION_RTOL * float(ref.abs().max())


def _conv_cases():
    for hw, c_in, c_out, _, _ in chip_smoke.CONV_SHAPES:
        for n in (1, 2):
            for masked in (False, True):
                yield n, hw, c_in, c_out, masked
                yield n, hw, c_out, c_in, masked  # the backward's conv


@pytest.mark.parametrize(
    ("n", "hw", "c_in", "c_out", "masked"), list(_conv_cases()),
)
def test_conv_plan_covers_the_output_and_fits(n, hw, c_in, c_out, masked):
    plan = conv3x3.conv_plan(n, hw, hw, c_in, c_out, masked, N_SM)
    assert plan.rows * plan.cols == 128
    tiles_y, tiles_x = -(-hw // plan.rows), -(-hw // plan.cols)
    ch_tiles = -(-c_out // plan.bn)
    assert tiles_y * plan.rows >= hw and tiles_x * plan.cols >= hw
    assert ch_tiles * plan.bn >= c_out
    assert plan.tiles == n * tiles_y * tiles_x * ch_tiles
    assert plan.smem_bytes <= conv3x3.SMEM_LIMIT
    assert plan.a_stages >= 2 and plan.b_stages >= 3
    assert plan.k_pad >= 9 * c_in and plan.k_pad % conv3x3.K_STEP == 0
    # K steps: every (tap, 32-channel slab) or every 32-wide K chunk.
    steps = plan.slabs * plan.taps
    assert steps * conv3x3.K_STEP == (
        9 * c_in if plan.halo else plan.k_pad
    )
    # The split covers every slab once.
    assert plan.split_slabs * (plan.splits - 1) < plan.slabs
    assert plan.split_slabs * plan.splits >= plan.slabs
    assert 1 <= plan.blocks <= N_SM
    # The split over K is chosen per image: a batch sums each image in
    # the order it is summed alone.
    alone = conv3x3.conv_plan(1, hw, hw, c_in, c_out, masked, N_SM)
    assert (plan.splits, plan.split_slabs) == (
        alone.splits, alone.split_slabs,
    )


@pytest.mark.parametrize(("p", "c"), chip_smoke.GRAM_SHAPES)
def test_gram_plan_covers_the_rows_and_fits(p, c) -> None:
    plan = gram.gram_plan(p, c, N_SM)
    side = -(-c // 64)
    assert plan.pairs == side * (side + 1) // 2
    assert plan.rows % 32 == 0
    assert plan.splits * plan.rows >= p > (plan.splits - 1) * plan.rows
    assert plan.groups * plan.group >= plan.splits
    assert (plan.groups - 1) * plan.group < plan.splits
    # Two blocks share an SM's 228 KB (1 KB of it reserved per block).
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.pairs * plan.splits <= 2 * N_SM


@pytest.mark.parametrize(
    ("h", "w", "ci", "co"), [(12, 10, 8, 16), (9, 9, 3, 8)],
)
def test_masked_plain_conv_is_the_jax_relu_vjp(h, w, ci, co) -> None:
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    g = rng.normal(size=(1, h, w, co)).astype(np.float32)
    w9j = hwio_to_stencil(jnp.asarray(wt))
    out_j, vjp = jax.vjp(
        lambda xx: jax_conv(xx, w9j, jnp.asarray(b), True, True),
        jnp.asarray(x),
    )
    (ref,) = vjp(jnp.asarray(g))
    w9 = torch.from_numpy(wt.reshape(9, ci, co))
    ours = conv3x3.conv3x3_plain(
        torch.from_numpy(g), flip_stencil(w9), None, False,
        torch.from_numpy(np.array(out_j)),
    )
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours.numpy(), ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()),
    )


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    assert build.CSRC / "tf32x3.cuh" in build.local_headers(
        build.CSRC / "conv3x3.cu",
    )
    for name in ("conv3x3.cu", "gram.cu", "tf32x3.cuh"):
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    _, before = build._target("gram")  # noqa: SLF001
    header = tmp_path / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    _, after = build._target("gram")  # noqa: SLF001
    assert before != after
