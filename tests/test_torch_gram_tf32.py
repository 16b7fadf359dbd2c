"""The TF32 Gram kernel's launch plan and its block walk, on the CPU.

``csrc/gram.cu``'s ``gram_tf32_kernel`` cannot run here, so its
indexing is checked here before it runs on a card:

- ``gram_plan(mode="tf32")`` at every Gram shape set the card's smoke
  script drives (the five taps at 512x512, 1024x1024, S = 4 at
  512x512, the 2048x2048 level's first tap, 1280x720, and the 528x960
  coarse level's): two blocks' shared memory fit an SM, a split's rows
  are whole 64-row slabs, the splits cover P once and the groups the
  splits, and the plan does not depend on the batch;
- a plain-PyTorch walk of a plan's blocks (:func:`_walk`), written
  with the kernel's own index formulas: each 64-row slab as TMA lands
  it (two 32-channel boxes, the 128-byte swizzle, zero past P and C);
  F_j rounded and transposed into the double-buffered K-major tile by
  the transpose roles; A as the register fragments' slab offsets, or,
  on a diagonal pair, through the same descriptor as B, both read
  through an emulation of the address-based swizzle; a fresh
  accumulator every 8 slabs, promoted into the running sum; the
  partial tile, the two-level fixed-order sum, the clamp, the scale
  and the mirror. Slots and tiles never written are NaN. It matches
  ``gram_plain(mode="tf32")`` within 1e-5 of the largest magnitude
  (C not a multiple of 64, P not a multiple of 64, splits in several
  groups, promotions), each image of a batch is bit-equal to its walk
  alone, and it matches the JAX package's Pallas Gram (interpret mode,
  HIGHEST) fed the same features rounded to tf32 with numpy.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.ops.pallas_gram import _raw_gram
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.ops import gram
from style_transfer_visualizer_tpu_torch.ops.tf32 import round_tf32
from style_transfer_visualizer_tpu_torch.tools import gram_parts

N_SM = 132
RTOL = 1e-5
KP = 64             # pixel rows per slab
TILE = 64           # output tile edge
PROMOTE = 8         # slabs per promotion
ROW_BYTES = 128
SMEM_PER_SM = 228 * 1024   # 1 KB of it reserved per block
# (P, C) of the five style taps at 512x512.
TAPS_512 = [(262144, 64), (65536, 128), (16384, 256), (4096, 512),
            (1024, 512)]


def _shape_sets() -> dict[str, list[tuple[int, int, int]]]:
    """``(S, P, C)`` of each Gram shape set the smoke script drives."""
    return {
        "512": [(1, p, c) for p, c in TAPS_512],
        "1024": [(1, 4 * p, c) for p, c in TAPS_512],
        "s4_512": [(4, p, c) for p, c in TAPS_512],
        "level_2048": [(1, 2048 * 2048, 64)],
        "720p": [
            (1, (720 >> k) * (1280 >> k), c)
            for k, (_, c) in enumerate(TAPS_512)
        ],
        "528x960": [
            (2, (528 >> k) * (960 >> k), c)
            for k, (_, c) in enumerate(TAPS_512)
        ],
    }


@pytest.mark.parametrize(
    ("key", "s", "p", "c"),
    [(k, *case) for k, cases in _shape_sets().items() for case in cases],
)
def test_plan_at_every_driven_shape(key, s, p, c) -> None:
    del key
    plan = gram.gram_plan(p, c, N_SM, "tf32")
    side = -(-c // TILE)
    assert plan.pairs == side * (side + 1) // 2
    assert plan.rows % KP == 0
    assert plan.splits * plan.rows >= p > (plan.splits - 1) * plan.rows
    assert plan.groups * plan.group >= plan.splits
    assert (plan.groups - 1) * plan.group < plan.splits
    # Slots of F_i and F_j, or twice as many of F_i alone when every
    # pair is diagonal; the same shared memory either way: the ring,
    # the two transposed tiles, 4 slots' barriers.
    assert plan.stages == (4 if side == 1 else 2)
    slot = (1 if side == 1 else 2) * KP * TILE * 4
    assert plan.smem_bytes == (
        1024 + plan.stages * slot + 2 * TILE * KP * 4 + 16 * 4
    ) == gram.gram_plan(4096, 512, N_SM, "tf32").smem_bytes
    assert 2 * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    assert plan.pairs * plan.splits <= 2 * N_SM or plan.splits == 1
    # The same rule as the other modes, in 64-row units; no batch in it.
    assert (plan.splits, plan.rows) == gram.split_rows(p, c, N_SM, KP)
    del s


# ---- the walk


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _swizzled(byte_addr):
    """The 128-byte swizzle of a 1024-byte-aligned buffer."""
    return byte_addr ^ (((byte_addr >> 7) & 7) << 4)


def swz(row, col):
    """The kernel's ``swz``."""
    row, col = np.asarray(row), np.asarray(col)
    return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3)


def slab1_off(k, m):
    """The kernel's ``slab1_off``: (pixel k, channel m) of a slab."""
    m = np.asarray(m)
    return (m >> 5) * (KP * 32) + swz(k, m & 31)


def _desc_read(buf: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """``rows`` x 8 tf32 values through a K-major descriptor at
    ``start`` bytes (128-byte swizzle, base offset 0)."""
    i = np.arange(rows)[:, None]
    pre = start + (i // 8) * 1024 + (i % 8) * ROW_BYTES
    pre = pre + 4 * np.arange(8)[None, :]
    return buf[_t(_swizzled(pre) // 4)]


def _land(slot: torch.Tensor, f: torch.Tensor, ch0: int, p0: int) -> None:
    """Two TMA boxes (32 channels x 64 rows) of image ``f`` at (ch0,
    p0) and (ch0 + 32, p0): element (row k, channel cc) of box b at
    the swizzle of ``b * 8192 + k * 128 + 4 * cc``; zero past P or C."""
    p, c = f.shape
    e = np.arange(2 * KP * 32)
    box, rest = np.divmod(e, KP * 32)
    k, cc = np.divmod(rest, 32)
    row, ch = p0 + k, ch0 + 32 * box + cc
    ok = (row < p) & (ch < c)
    vals = f[_t(np.minimum(row, p - 1)), _t(np.minimum(ch, c - 1))]
    addr = box * KP * 32 * 4 + _swizzled(k * ROW_BYTES + 4 * cc)
    slot[_t(addr // 4)] = torch.where(_t(ok), vals, torch.tensor(0.0))


def _transpose(fj: torch.Tensor, tile: torch.Tensor) -> None:
    """Slab's F_j into a K-major tile: thread t (n = t % 64, quads
    t // 64, + 2, ...) writes tile[(k >> 5) * 2048 + swz(n, k & 31)] =
    tf32(F_j[k][n]) for 4 pixels k a store."""
    tid = np.arange(128)
    tn, tq = tid & 63, tid >> 6
    k = 4 * (tq[:, None] + 2 * np.arange(KP // 8)[None, :])   # (128, 8)
    k = (k[:, :, None] + np.arange(4)).reshape(128, -1)       # (128, 32)
    n = np.broadcast_to(tn[:, None], k.shape)
    dst = (k >> 5) * (TILE * 32) + swz(n, k & 31)
    assert len(np.unique(dst)) == TILE * KP                   # each once
    tile[_t(dst)] = round_tf32(fj[_t(slab1_off(k, n))])


def _block(plan, f: torch.Tensor, i0: int, j0: int, split: int):
    """One block's partial tile (64 x 64)."""
    p = f.shape[0]
    diag = i0 == j0
    p_begin = split * plan.rows
    p_end = min(p_begin + plan.rows, p)
    steps = -(-(p_end - p_begin) // KP)
    slab_floats = KP * TILE
    slot_floats = (1 if plan.pairs == 1 else 2) * slab_floats
    slots = torch.full((plan.stages, slot_floats), float("nan"))
    tiles = torch.full((2, 2 * TILE * 32), float("nan"))
    acc = torch.zeros((TILE, TILE))
    part = torch.full((TILE, TILE), float("nan"))
    for s in range(steps):
        slot = slots[s % plan.stages]
        fi = slot[:slab_floats]
        fj = fi if diag else slot[slab_floats:]
        _land(fi, f, i0, p_begin + s * KP)
        if not diag:
            _land(fj, f, j0, p_begin + s * KP)
        tile = tiles[s & 1]
        _transpose(fj, tile)
        for c in range(KP // 32):
            bmat = torch.cat([
                _desc_read(tile, 4 * c * TILE * 32 + 32 * kk, TILE)
                for kk in range(4)
            ], dim=1)
            if diag:
                amat = bmat
            else:
                k = c * 32 + np.arange(32)[None, :]
                m = np.arange(TILE)[:, None]
                amat = round_tf32(fi[_t(slab1_off(k, m))])
            prod = amat @ bmat.T
            part = prod if c == 0 and s % PROMOTE == 0 else part + prod
        if s % PROMOTE == PROMOTE - 1 or s == steps - 1:
            acc = acc + part
    return acc


def _sum_tiles(tiles: list[torch.Tensor]) -> torch.Tensor:
    out = torch.zeros((TILE, TILE))
    for t in tiles:
        out = out + t
    return out


def _walk(flat: torch.Tensor, norm: float, plan) -> tuple[torch.Tensor, ...]:
    """The kernel's computation for an ``(S, P, C)`` batch: ``(raw,
    G)``, block by block of the (pairs, splits, S) grid."""
    s_n, _, c = flat.shape
    side = -(-c // TILE)
    raw = torch.full((s_n, c, c), float("nan"))
    g = torch.full((s_n, c, c), float("nan"))
    for img in range(s_n):
        for bi in range(side):
            for bj in range(bi, side):
                parts = [
                    _block(plan, flat[img], bi * TILE, bj * TILE, q)
                    for q in range(plan.splits)
                ]
                groups = [
                    _sum_tiles(parts[gq * plan.group:(gq + 1) * plan.group])
                    for gq in range(plan.groups)
                ]
                total = _sum_tiles(groups)
                r, cc = np.meshgrid(np.arange(TILE), np.arange(TILE),
                                    indexing="ij")
                i, j = bi * TILE + r, bj * TILE + cc
                keep = (i < c) & (j < c) & ~((bi == bj) & (r > cc))
                vals = total[_t(r[keep]), _t(cc[keep])]
                gv = torch.clamp(vals, max=CLAMP) / norm
                for a, b in ((i, j), (j, i)):
                    raw[img, _t(a[keep]), _t(b[keep])] = vals
                    g[img, _t(a[keep]), _t(b[keep])] = gv
    assert not raw.isnan().any()
    return raw, g


def _close(ours: torch.Tensor, ref: torch.Tensor) -> None:
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((ours - ref).abs().max())
    assert err <= RTOL * scale, (err, scale)


def _features(seed: int, s: int, p: int, c: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=(s, p, c)) * scale).astype(np.float32),
    )


# (S, P, C, n_sm, scale): one diagonal pair, P ragged, promotions
# within a split (11 slabs), two splits in one group; C = 96 (three
# pairs, one diagonal, channels past C zero) with eight splits in three
# groups; C = 4 (one padded tile); an active clamp.
WALK_CASES = [
    (1, 1300, 64, 1, 1.0),
    (1, 700, 96, 4, 1.0),
    (1, 100, 4, N_SM, 1.0),
    (1, 640, 64, 2, 60.0),
]


@pytest.mark.parametrize(("s", "p", "c", "n_sm", "scale"), WALK_CASES)
def test_walk_rebuilds_the_gram(s, p, c, n_sm, scale) -> None:
    flat = _features(p + c, s, p, c, scale)
    plan = gram.gram_plan(p, c, n_sm, "tf32")
    raw, g = _walk(flat, float(p * c), plan)
    raw_p, g_p = gram.gram_plain_batched(flat, CLAMP, float(p * c), "tf32")
    _close(raw, raw_p)
    _close(g, g_p)
    assert torch.equal(raw, raw.mT)


def test_walk_covers_every_path() -> None:
    """Promotions inside a split, several groups, diagonal and off-
    diagonal pairs, a padded tile, an active clamp."""
    plans = [gram.gram_plan(p, c, n, "tf32") for _, p, c, n, _ in WALK_CASES]
    assert max(p.rows // KP for p in plans) > PROMOTE
    assert max(p.groups for p in plans) > 1
    assert {p.pairs for p in plans} >= {1, 3}
    assert any(c % TILE for _, _, c, _, _ in WALK_CASES)
    big = _features(640 + 64, 1, 640, 64, 60.0)[0]
    assert float((big.T @ big).max()) > CLAMP


def test_walk_batch_is_each_image_alone() -> None:
    """The plan and the sums are per image: a batch's walk gives each
    image's walk alone, bit for bit."""
    flat = _features(5, 3, 700, 96)
    plan = gram.gram_plan(700, 96, 4, "tf32")
    raw, g = _walk(flat, 700.0 * 96, plan)
    for i in range(3):
        one_raw, one_g = _walk(flat[i:i + 1], 700.0 * 96, plan)
        assert torch.equal(raw[i], one_raw[0])
        assert torch.equal(g[i], one_g[0])


def _np_tf32(a: np.ndarray) -> np.ndarray:
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32,
    )


@pytest.mark.parametrize(("p", "c"), [(1300, 64), (700, 96)])
def test_walk_matches_the_pallas_gram(p, c) -> None:
    """The raw Gram is the JAX package's Pallas Gram (interpret mode,
    ``Precision.HIGHEST``) of the features rounded to tf32 with numpy,
    within 1e-5."""
    flat = _features(7, 1, p, c)
    ref = np.asarray(_raw_gram(
        jnp.asarray(_np_tf32(flat[0].numpy())), True,
        jax.lax.Precision.HIGHEST,
    ))
    raw, _ = _walk(flat, float(p * c), gram.gram_plan(p, c, 2, "tf32"))
    _close(raw[0], torch.from_numpy(ref.copy()))
    assert math.isfinite(float(raw.abs().max()))


def test_gram_parts_edits_still_apply() -> None:
    """``tools/gram_parts.py`` times copies of the kernel with parts cut
    out by editing its source: each edit still finds its text, and each
    copy differs from the last."""
    sources = [gram_parts._variant_source(edits)  # noqa: SLF001
               for edits in gram_parts.VARIANTS.values()]
    assert len(set(sources)) == len(sources)
    assert "sum_partials<true>" in sources[0]
    assert "sum_partials<true>" not in sources[1]
