"""The kernels' modes: their plain versions, plans, counters and refusals.

- each mode's plain conv and Gram (``conv3x3_plain``, ``gram_plain``:
  the fp32 products; those of tf32-rounded operands; the three
  products of the hi/lo split) against a numpy float64 reference of
  the same rounding, within 1e-6 of the reference's largest magnitude:
  ``ieee`` the exact products; ``tf32`` TF32-rounded operands (rounded
  in numpy on the bits, nearest with ties away), exact sums;
  ``tf32x3`` the three products ``lo*hi + hi*lo + hi*hi``; the dropped
  ``lo*lo`` is at most 2^-22 of the operands' product magnitudes;
  ``tf32`` is further from fp32 than ``tf32x3`` by more than 10x, so
  the modes are distinct;
- launch plans by mode (the TF32 conv's B slots hold hi only, the IEEE
  Gram takes no dynamic shared memory), the per-mode launch counters;
- refusals: an unknown mode raises in every wrapper and plan; a CPU
  tensor given to a kernel wrapper raises (no fallback to the plain
  version); the Gram backward's TF32 operands are rounded on the card
  only.

Card-only tests (``cuda`` marker; skipped here, decided inside the
fixture): each mode of each kernel against its plain version at small
ragged shapes, batched Grams bit-equal to single launches, the
feature path at each tier launching the modes its policy names, and
an unknown mode raising on CUDA tensors. The file imports no JAX, so
on a card, without the JAX test environment:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_precision_modes.py
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.models import features
from style_transfer_visualizer_tpu_torch.models.arch import VGG19
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    init_random_params,
    pack_stencil,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram
from style_transfer_visualizer_tpu_torch.ops import precision as pp

REL = 1e-6


def _round_tf32_np(a: np.ndarray) -> np.ndarray:
    """TF32 of float32 ``a``, nearest with ties away, on the bits."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32,
    )


def _split_np(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _round_tf32_np(a)
    return hi, _round_tf32_np((a - hi).astype(np.float32))


def _conv64(x: np.ndarray, w9: np.ndarray) -> np.ndarray:
    """SAME 3x3 conv of NHWC ``x`` with ``(9, C_in, C_out)`` in float64."""
    x = np.asarray(x, np.float64)
    w9 = np.asarray(w9, np.float64)
    n, h, w, _ = x.shape
    pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((n, h, w, w9.shape[2]))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        out += pad[:, dy:dy + h, dx:dx + w, :] @ w9[tap]
    return out


def _rel(ours, ref) -> float:
    ours = np.asarray(ours, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    w9 = (rng.normal(size=(9, 6, 7)) * 0.3).astype(np.float32)
    return x, w9


def _plain_conv(x, w9, mode):
    return conv3x3.conv3x3_plain(
        torch.from_numpy(x), torch.from_numpy(w9), None, False, mode=mode,
    ).numpy()


def test_ieee_plain_conv_is_exact_fp32(conv_case) -> None:
    x, w9 = conv_case
    assert _rel(_plain_conv(x, w9, "ieee"), _conv64(x, w9)) <= REL


def test_tf32_plain_conv_rounds_the_operands(conv_case) -> None:
    x, w9 = conv_case
    ref = _conv64(_round_tf32_np(x), _round_tf32_np(w9))
    assert _rel(_plain_conv(x, w9, "tf32"), ref) <= REL


def test_tf32x3_plain_conv_is_three_products(conv_case) -> None:
    x, w9 = conv_case
    (x_hi, x_lo), (w_hi, w_lo) = _split_np(x), _split_np(w9)
    three = _conv64(x_lo, w_hi) + _conv64(x_hi, w_lo) + _conv64(x_hi, w_hi)
    assert _rel(_plain_conv(x, w9, "tf32x3"), three) <= REL
    # The dropped term: at most 2^-22 of the products' magnitudes.
    dropped = np.abs(_conv64(x_lo, w_lo)).max()
    assert dropped <= 2.0**-22 * _conv64(np.abs(x), np.abs(w9)).max()


def test_modes_are_distinct(conv_case) -> None:
    x, w9 = conv_case
    exact = _conv64(x, w9)
    err_tf32 = _rel(_plain_conv(x, w9, "tf32"), exact)
    err_x3 = _rel(_plain_conv(x, w9, "tf32x3"), exact)
    assert err_tf32 > 10 * err_x3
    assert err_tf32 > 1e-5


def test_plain_conv_mask_and_bias_per_mode(conv_case) -> None:
    x, w9 = conv_case
    rng = np.random.default_rng(6)
    mask = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    xm = np.where(mask.numpy() > 0, x, 0.0).astype(np.float32)
    for mode in pp.MODES:
        got = conv3x3.conv3x3_plain(
            torch.from_numpy(x), torch.from_numpy(w9), b, True, mask,
            mode=mode,
        ).numpy()
        base = _plain_conv(xm, w9, mode)
        ref = np.maximum(base + b.numpy(), 0.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def gram_case():
    rng = np.random.default_rng(8)
    return rng.normal(size=(300, 12)).astype(np.float32)


def _plain_gram(f, mode):
    raw, g = gram.gram_plain(torch.from_numpy(f), CLAMP, 3600.0, mode)
    return raw.numpy(), g.numpy()


def test_gram_plain_modes_against_float64(gram_case) -> None:
    f = gram_case
    f64 = f.astype(np.float64)
    raw, _ = _plain_gram(f, "ieee")
    assert _rel(raw, f64.T @ f64) <= REL
    r = _round_tf32_np(f).astype(np.float64)
    raw, _ = _plain_gram(f, "tf32")
    assert _rel(raw, r.T @ r) <= REL
    hi, lo = (a.astype(np.float64) for a in _split_np(f))
    raw, _ = _plain_gram(f, "tf32x3")
    assert _rel(raw, lo.T @ hi + hi.T @ lo + hi.T @ hi) <= REL
    err_tf32 = _rel(_plain_gram(f, "tf32")[0], f64.T @ f64)
    err_x3 = _rel(_plain_gram(f, "tf32x3")[0], f64.T @ f64)
    assert err_tf32 > 10 * err_x3


def test_gram_plain_clamps_before_the_divide_in_every_mode() -> None:
    f = np.full((4, 2), 1e3, np.float32)
    for mode in pp.MODES:
        raw, g = gram.gram_plain(torch.from_numpy(f), CLAMP, 8.0, mode)
        assert float(raw[0, 0]) == pytest.approx(4e6, rel=1e-3)
        assert float(g[0, 0]) == CLAMP / 8.0


def test_batched_plain_gram_is_per_image(gram_case) -> None:
    f = torch.from_numpy(np.stack([gram_case, 2 * gram_case]))
    for mode in pp.MODES:
        raw, g = gram.gram_plain_batched(f, CLAMP, 10.0, mode)
        for i in range(2):
            one_raw, one_g = gram.gram_plain(f[i], CLAMP, 10.0, mode)
            assert torch.equal(raw[i], one_raw)
            assert torch.equal(g[i], one_g)


# ---- plans, counters, refusals


@pytest.mark.parametrize(("h", "c_in", "c_out"), [
    (512, 3, 64), (512, 64, 64), (256, 128, 128), (64, 512, 512),
    (45, 512, 512),
])
def test_conv_plan_by_mode(h, c_in, c_out) -> None:
    # 3xTF32 plans csrc/conv3x3.cu (B slots hold the hi and lo boxes),
    # TF32 its own kernel, csrc/conv3x3_tf32.cu (one hi box a B slot,
    # three barrier arrays for A, 256-pixel tiles where A is read
    # through descriptors).
    x3 = conv3x3.conv_plan(1, h, h, c_in, c_out, True, 132)
    one = conv3x3.tf32_plan(1, h, h, c_in, c_out, True, 132)
    assert (one.bn, one.k_pad, one.halo) == (x3.bn, x3.k_pad, x3.halo)
    assert one.rows * one.cols == 128 * one.wm
    assert x3.b_stages >= 3 and one.b_stages >= 3  # noqa: PT018, PLR2004
    assert max(x3.smem_bytes, one.smem_bytes) <= conv3x3.SMEM_LIMIT
    b_slot = one.bn * conv3x3.K_STEP * 4
    assert x3.smem_bytes == (
        1024 + x3.a_stages * x3.a_slot_bytes + x3.b_stages * 2 * b_slot
        + 16 * (x3.a_stages + x3.b_stages) + 16
    )
    assert one.smem_bytes == (
        1024 + (one.a_stages + one.mask_slab) * one.a_slot_bytes
        + one.b_stages * b_slot + 8 * (3 * one.a_stages + 2 * one.b_stages)
        + 16 + 16
    )
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3.tf32_plan(1, h, h, c_in, c_out, True, 132, 3)


def test_gram_plan_by_mode() -> None:
    plans = {m: gram.gram_plan(262144, 64, 132, m) for m in pp.MODES}
    assert plans["tf32x3"] == gram.gram_plan(262144, 64, 132)
    # IEEE: its own kernel's shared memory (the ring of F_i slabs, the
    # four k-groups' register tiles) and blocks an SM.
    ieee = plans["ieee"]
    assert ieee.smem_bytes == gram.ieee_smem_bytes(1, ieee.stages)
    assert (ieee.slab, ieee.kgroups, ieee.blocks_per_sm) == (64, 4, 2)
    # TF32: two slots of 64-row F_i and F_j slabs, two transposed
    # tiles of a slab each, the mbarriers.
    # (C = 64: every pair diagonal, twice the slots of F_i alone.)
    assert plans["tf32"].smem_bytes == (
        1024 + 4 * (64 * 64 * 4) + 2 * (64 * 64 * 4) + 16 * 4
    )
    assert (plans["tf32"].stages, plans["tf32"].rows % 64) == (4, 0)
    assert gram.gram_plan(262144, 128, 132, "tf32").stages == 2  # noqa: PLR2004
    # Each mode splits P by the one rule in its own slabs and blocks an
    # SM.
    for p in plans.values():
        assert (p.splits, p.rows) == gram.split_rows(
            262144, 64, 132, p.slab, blocks_per_sm=p.blocks_per_sm,
        )
        assert p.group == math.isqrt(p.splits - 1) + 1
    for p in plans.values():
        assert p.splits * p.rows >= 262144 > (p.splits - 1) * p.rows
    with pytest.raises(ValueError, match="unknown mode"):
        gram.gram_plan(64, 64, 132, "bf16")


def test_mode_counters() -> None:
    counters = build.ModeCounters("k", pp.MODES)
    counters["ieee"].count += 2
    counters["tf32"].count += 1
    assert counters.count == 3
    assert counters.launched() == 0  # no device slot yet
    assert counters.launched_by_mode() == dict.fromkeys(pp.MODES, 0)
    counters.reset()
    assert counters.count == 0
    with pytest.raises(ValueError, match="unknown kernel mode"):
        counters["bf16"]
    assert set(conv3x3.launches.by_mode) == set(pp.MODES)
    assert set(gram.launches.by_mode) == set(pp.MODES)


def test_csrc_builds_every_mode_source() -> None:
    assert build.SOURCES == ("conv3x3", "conv3x3_ieee", "conv3x3_tf32", "gram")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()


def _stencils(c_in=4, c_out=5):
    w9 = torch.randn((9, c_in, c_out))
    w9f = flip_stencil(w9)
    return w9, w9f, pack_stencil(w9), pack_stencil(w9f)


@pytest.mark.parametrize("mode", ["bf16", "fp32", "", None])
def test_unknown_mode_raises_everywhere(mode) -> None:
    w9, w9f, wk, wkf = _stencils()
    x = torch.randn((1, 4, 4, 4))
    with pytest.raises(ValueError, match="unknown mode"):
        conv3x3.conv3x3_kernel(x, wk, None, False, mode=mode)
    if mode is not None:
        with pytest.raises(ValueError, match="unknown mode"):
            conv3x3.conv3x3_bias_relu(
                x, w9, w9f, torch.zeros(5), True, wk, wkf, mode=mode,
            )
    with pytest.raises(ValueError, match="unknown mode"):
        conv3x3.conv3x3_plain(x, w9, None, False, mode=mode)
    with pytest.raises(ValueError, match="unknown mode"):
        conv3x3.mode_stencil(mode, w9, wk)
    with pytest.raises(ValueError, match="unknown mode"):
        gram.gram_plain(torch.randn((8, 4)), CLAMP, 1.0, mode)
    with pytest.raises(ValueError):  # noqa: PT011 - the level table's
        gram.gram_matrix(torch.randn((1, 2, 2, 4)), precision=mode or "x")


@pytest.mark.parametrize("mode", pp.MODES)
def test_kernel_wrappers_refuse_cpu_tensors(mode) -> None:
    w9, _, wk, _ = _stencils()
    x = torch.randn((1, 4, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv3x3.conv3x3_kernel(
            x, conv3x3.mode_stencil(mode, w9, wk), None, False, mode=mode,
        )
    with pytest.raises(ValueError, match="CUDA tensor"):
        gram.gram_kernel(torch.randn((8, 4)), CLAMP, 1.0, mode)


def test_mode_stencils_are_the_load_time_forms() -> None:
    w9, _, wk, _ = _stencils()
    assert conv3x3.mode_stencil("ieee", w9, wk) == (w9,)
    assert conv3x3.mode_stencil("tf32", w9, wk)[0] is wk[0]
    assert conv3x3.mode_stencil("tf32x3", w9, wk) == tuple(wk)


def test_gram_backward_rounds_only_on_the_card() -> None:
    flat, sym = torch.randn((6, 3)), torch.randn((3, 3))
    for mode in pp.MODES:
        f, s = gram._bwd_operands(flat, sym, mode)  # noqa: SLF001
        assert f is flat
        assert s is sym


# ---- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(ours: torch.Tensor, ref: torch.Tensor) -> None:
    err = float((ours - ref).abs().max())
    assert err <= 1e-4 * max(float(ref.abs().max()), 1e-30)


def _rand(seed: int, *shape: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.tensor(
        (rng.normal(size=shape) * scale).astype(np.float32), device="cuda",
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", pp.MODES)
@pytest.mark.parametrize(("n", "h", "w", "ci", "co"), [
    (1, 7, 13, 3, 64), (2, 9, 9, 17, 70), (1, 16, 40, 64, 5),
    (1, 12, 12, 64, 3), (2, 10, 9, 32, 128),
])
def test_conv_mode_matches_its_plain(cuda, mode, n, h, w, ci, co) -> None:
    del cuda
    x = _rand(0, n, h, w, ci)
    w9 = _rand(1, 9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
    b = _rand(2, co, scale=0.1)
    g = _rand(3, n, h, w, co)
    w9f = flip_stencil(w9)
    st = conv3x3.mode_stencil(mode, w9, pack_stencil(w9))
    stf = conv3x3.mode_stencil(mode, w9f, pack_stencil(w9f))
    before = conv3x3.launches[mode].launched()
    for relu in (True, False):
        _close(
            conv3x3.conv3x3_kernel(x, st, b, relu, mode=mode),
            conv3x3.conv3x3_plain(x, w9, b, relu, mode=mode),
        )
    out = conv3x3.conv3x3_kernel(x, st, b, True, mode=mode)
    _close(
        conv3x3.conv3x3_kernel(g, stf, None, False, out, mode=mode),
        conv3x3.conv3x3_plain(g, w9f, None, False, out, mode=mode),
    )
    assert conv3x3.launches[mode].launched() == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", pp.MODES)
@pytest.mark.parametrize(("s", "p", "c"), [
    (1, 1000, 64), (1, 333, 130), (3, 257, 12), (2, 4096, 256),
])
def test_gram_mode_matches_its_plain(cuda, mode, s, p, c) -> None:
    del cuda
    f = _rand(4, s, p, c)
    before = gram.launches[mode].launched()
    raw, g = gram.gram_kernel_batched(f, CLAMP, float(p * c), mode)
    raw_p, g_p = gram.gram_plain_batched(f, CLAMP, float(p * c), mode)
    for i in range(s):
        _close(raw[i], raw_p[i])
        _close(g[i], g_p[i])
        one, _ = gram.gram_kernel(f[i].contiguous(), CLAMP, float(p * c), mode)
        assert torch.equal(raw[i], one)
        assert torch.equal(raw[i], raw[i].T)
    assert gram.launches[mode].launched() == before + 1 + s


@pytest.mark.cuda
@pytest.mark.parametrize("tier", pp.PRECISION_NAMES)
def test_features_launch_the_policy_modes(cuda, tier) -> None:
    params = init_random_params(0, cuda)
    prec = pp.resolve_precision(tier)
    conv3x3.launches.reset()
    gram.launches.reset()
    # From numpy: the card's default generator may be held by a CUDA
    # graph an earlier test captured.
    x = _rand(8, 1, 32, 32, 3).requires_grad_(True)
    acts = features.extract_features(params, x, (0, 5, 10), prec)
    loss = sum(
        features.gram_matrix(a, precision=prec).sum() for a in acts.values()
    )
    loss.backward()
    want_conv = dict.fromkeys(pp.MODES, 0)
    for idx in (i for i in VGG19.conv_indices if i <= 10):
        want_conv[pp.kernel_mode(pp.conv_precision(prec, idx))] += 1
        want_conv[pp.kernel_mode(pp.conv_bwd_precision(prec, idx))] += 1
    want_gram = dict.fromkeys(pp.MODES, 0)
    want_gram[pp.kernel_mode(pp.gram_precision(prec))] = 3
    assert conv3x3.launches.launched_by_mode() == want_conv
    assert gram.launches.launched_by_mode() == want_gram


@pytest.mark.cuda
def test_unknown_mode_raises_on_the_card(cuda) -> None:
    del cuda
    x = _rand(5, 1, 4, 4, 32)
    w9 = _rand(6, 9, 32, 8)
    with pytest.raises(ValueError, match="unknown mode"):
        conv3x3.conv3x3_kernel(x, pack_stencil(w9), None, False, mode="bf16")
    with pytest.raises(ValueError, match="unknown mode"):
        gram.gram_kernel(_rand(7, 64, 8), CLAMP, 1.0, "bf16")
