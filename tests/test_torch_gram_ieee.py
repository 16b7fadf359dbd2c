"""The IEEE Gram kernel's launch plan and its block walk, on the CPU.

``csrc/gram.cu``'s ``gram_ieee_kernel`` cannot run here, so its
indexing is checked here before it runs on a card:

- ``gram_plan(mode="ieee")`` at every Gram shape set the card's smoke
  script drives (the five taps at 512x512, 1024x1024, S = 4 at
  512x512, the 2048x2048 level's first tap, 1280x720, and the 528x960
  coarse level's): its slab, ring and shared memory, blocks an SM
  from the kernel's own registers and shared memory (16 warps), a
  split's rows whole slabs, the splits covering P once and the groups
  the splits, and a plan that does not depend on the batch; its
  constants are the kernel source's;
- a plain-PyTorch walk of a plan's blocks (:func:`_walk`), written with
  the kernel's own index formulas: the thread map (k-group, lane row
  and column) and each thread's 8 x 8 register tile; the slab copies
  into the ring's slots, each k-group's own rows (zero past the split's
  rows and past C, slots and halves never written NaN); a diagonal
  pair's one slab serving as both operands, each thread's one block
  above the diagonal, one of a diagonal quadrant and its shared-out
  diagonal elements, zeros below; each k-group's rows of a slab, its
  register tiles summed in k-group order; the partial tiles' two-level
  fixed-order sum, the clamp, the scale and the mirror. It matches
  ``gram_plain(mode="ieee")`` within 1e-5 of the largest magnitude (C
  not a multiple of 64, P not a multiple of the slab, splits in several
  groups), each image of a batch is bit-equal to its
  walk alone, and it matches the JAX package's Pallas Gram (interpret
  mode, HIGHEST) on the same features.
"""
from __future__ import annotations

import math
import re
from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.ops.pallas_gram import _raw_gram
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops import gram
from style_transfer_visualizer_tpu_torch.tools import gram_parts

N_SM = 132
RTOL = 1e-5
THREADS = 256
REGISTERS = 128
TILE = 64       # a tile pair's edge
N = TILE // 8   # threads a side of a k-group
HALF = TILE // 2
SMEM_PER_SM = 228 * 1024   # 1 KB of it reserved per block
REGISTERS_PER_SM = 65536
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
    del key, s  # the plan takes no batch: an image is planned alone
    plan = gram.gram_plan(p, c, N_SM, "ieee")
    tile = TILE
    side = -(-c // tile)
    assert (plan.slab, plan.kgroups) == (64, 4)
    assert plan.pairs == side * (side + 1) // 2
    assert plan.rows % plan.slab == 0
    assert plan.splits * plan.rows >= p > (plan.splits - 1) * plan.rows
    assert plan.groups * plan.group >= plan.splits
    assert (plan.groups - 1) * plan.group < plan.splits
    # Up to 8 splits sum in one level; more in about sqrt(splits) groups.
    assert plan.group == (
        plan.splits if plan.splits <= 8  # noqa: PLR2004
        else math.isqrt(plan.splits - 1) + 1
    )
    # The ring (F_i's slab, and F_j's where some pair is off the
    # diagonal), the k-groups' register tiles, the staged final tile.
    slot = (1 if side == 1 else 2) * plan.slab * tile * 4
    assert plan.stages == (4 if side == 1 else 3)
    assert plan.smem_bytes == max(
        plan.stages * slot, plan.kgroups * tile * tile * 4,
        tile * (tile + 1) * 4,
    ) <= gram.IEEE_SMEM_MAX
    # Blocks an SM from the kernel's own registers (128 a thread) and
    # shared memory: two, so 16 warps an SM.
    assert plan.blocks_per_sm == 2  # noqa: PLR2004
    assert plan.blocks_per_sm * THREADS * REGISTERS <= REGISTERS_PER_SM
    assert plan.blocks_per_sm * (plan.smem_bytes + 16 + 1024) <= SMEM_PER_SM
    assert plan.blocks_per_sm * THREADS // 32 == 16  # noqa: PLR2004
    # The split fills the card in that unit.
    assert (
        plan.pairs * plan.splits <= plan.blocks_per_sm * N_SM
        or plan.splits == 1
    )
    assert (plan.splits, plan.rows) == gram.split_rows(
        p, c, N_SM, plan.slab, blocks_per_sm=plan.blocks_per_sm,
    )


def test_plan_constants_are_the_kernel_source() -> None:
    """The plan's block, slab, largest shared memory and largest ring
    are the ones ``csrc/gram.cu`` launches and accepts, so a plan the
    kernel would refuse never leaves ``gram_plan``."""
    src = (build.CSRC / "gram.cu").read_text()

    def const(name: str) -> str:
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kIeeeThreads")) == gram.IEEE_THREADS == THREADS
    assert int(const("kIeeeSlab")) == gram.IEEE_SLAB
    assert const("kIeeeSmemMax") == f"{gram.IEEE_SMEM_MAX // 1024} * 1024"
    assert f"args.stages > {gram.IEEE_MAX_STAGES}" in src
    blocks = REGISTERS_PER_SM // (THREADS * REGISTERS)
    assert f"__launch_bounds__(kIeeeThreads, {blocks})" in src
    assert gram.IEEE_KGROUPS == THREADS // N ** 2


# ---- the walk


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@cache
def _thread_map() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's ``(kg, lt, r, c)`` of each of the 256 threads: k-group
    kg of ``N**2`` threads, lane lt in it; warp w of the k-group is lanes
    4 rows x 8 columns of its N x N threads."""
    tid = np.arange(THREADS)
    kg, lt = np.divmod(tid, N * N)
    w, q = lt >> 5, lt & 31
    r = 4 * (w // (N // 8)) + (q >> 3)
    c = 8 * (w % (N // 8)) + (q & 7)
    return kg, lt, r, c


def _blocks(row0, col0) -> tuple[np.ndarray, np.ndarray]:
    """The cells of the 4 x 4 blocks at ``(row0, col0)`` (one a thread)."""
    i = np.arange(4)[:, None]
    j = np.arange(4)[None, :]
    return (np.asarray(row0)[:, None, None] + i,
            np.asarray(col0)[:, None, None] + j)


@cache
def _staged(diag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A k-group's staged tile as the kernel's ``ieee_place`` and
    ``ieee_stage`` write it: ``(computed, writes)``, each element's flag
    of holding a product sum (else a zero) and its count of writes."""
    n, half = N, HALF
    kg, lt, r, c = (a[:n * n] for a in _thread_map())
    del kg
    computed = np.zeros((TILE, TILE), dtype=bool)
    writes = np.zeros((TILE, TILE), dtype=int)

    def put(row0, col0, value: bool, who=None) -> None:
        who = np.ones(len(r), dtype=bool) if who is None else who
        rows, cols = _blocks(np.broadcast_to(row0, r.shape)[who],
                             np.broadcast_to(col0, r.shape)[who])
        np.add.at(writes, (rows, cols), 1)
        computed[rows, cols] = value

    if not diag:
        for row0 in (4 * r, half + 4 * r):
            for col0 in (4 * c, half + 4 * c):
                put(row0, col0, True)
        return _t(computed), _t(writes)
    upper = r <= c
    a_off1 = np.where(upper, 4 * r, half + 4 * (n - 1 - r))
    b_off0 = np.where(upper, 4 * c, half + 4 * (n - 1 - c))
    put(4 * r, half + 4 * c, True)                      # upper right
    put(half + 4 * r, 4 * c, False)                     # lower left
    put(a_off1, b_off0, True)                           # diagonal quadrant
    put(half + 4 * (n - 1 - r), half + 4 * (n - 1 - c), False, r < c)
    put(4 * r, 4 * c, False, r > c)
    extra = 16 // n
    m, e = lt // n, (lt % n) * extra
    for k in range(extra):
        rows, cols = half + 4 * m + e // 4, half + 4 * m + e % 4 + k
        np.add.at(writes, (rows, cols), 1)
        computed[rows, cols] = True
    return _t(computed), _t(writes)


@pytest.mark.parametrize("diag", [False, True])
def test_thread_map_covers_each_tile_once(diag) -> None:
    """A k-group's threads write each element of its staged tile once,
    off the diagonal and on it; a quarter warp's loads read one float4
    of A and 8 distinct float4 of B in distinct banks; on a diagonal
    pair the elements that hold products are the 4 x 4 blocks on and
    above the diagonal, and every thread issues the same products: one
    block above the diagonal, one of a diagonal quadrant, 16 / N
    shared-out elements (no warp diverges)."""
    n = N
    computed, writes = _staged(diag)
    assert bool((writes == 1).all())
    kg, _, r, c = _thread_map()
    assert np.array_equal(np.bincount(kg), [n * n] * (THREADS // (n * n)))
    for quarter in range(THREADS // 8):
        lanes = slice(8 * quarter, 8 * quarter + 8)
        assert len(set(r[lanes])) == 1
        assert np.array_equal(np.sort(c[lanes] % 8), np.arange(8))
    if not diag:
        assert bool(computed.all())
        return
    blocks = computed.numpy().reshape(n * 2, 4, n * 2, 4)
    br, bc = np.meshgrid(np.arange(2 * n), np.arange(2 * n), indexing="ij")
    assert (blocks.all(axis=(1, 3)) == (br <= bc)).all()
    assert (blocks.any(axis=(1, 3)) == (br <= bc)).all()
    # Products a thread a row: 16 + 16 + 16 / n, against 64 off it.
    assert 2 * 16 * n * n + 16 * n == int((br <= bc).sum()) * 16


def _land(slot: torch.Tensor, f: torch.Tensor, pr: dict, p0: int,
          plan, kg: int) -> None:
    """The kernel's ``ieee_load`` for k-group ``kg``: copy e = lt +
    ``N**2`` u of its lane lt is row ``kg * rows + e // 16`` of the slab
    (``rows`` = slab / k-groups), channels ``4 (e % 16)`` .. + 3, of F_i
    into the slot's first half and, off the diagonal, of F_j into its
    second; zero past the split's last row and past C."""
    p, c = f.shape
    tile, slab = TILE, plan.slab
    lanes = N ** 2
    rows = slab // plan.kgroups
    per = rows * tile // 4 // lanes
    assert per == 4  # noqa: PLR2004
    e = (np.arange(lanes)[:, None] + lanes * np.arange(per)).ravel()
    assert np.array_equal(np.sort(e), np.arange(rows * tile // 4))
    row, col = np.divmod(e, tile // 4)
    row = kg * rows + row
    col = 4 * col[:, None] + np.arange(4)
    pix = (p0 + row)[:, None] + 0 * col
    halves = [(0, pr["i0"])] if pr["diag"] else [(0, pr["i0"]),
                                                  (1, pr["j0"])]
    for half, ch0 in halves:
        ch = ch0 + col
        ok = (pix < pr["p_end"]) & (ch < c)
        vals = f[_t(np.minimum(pix, p - 1)), _t(np.minimum(ch, c - 1))]
        dst = half * slab * tile + row[:, None] * tile + col
        slot[_t(dst)] = torch.where(_t(ok), vals, torch.tensor(0.0))


def _block(plan, f: torch.Tensor, bi: int, bj: int, split: int):
    """One block's partial tile (64 x 64)."""
    p = f.shape[0]
    tile, slab, groups = TILE, plan.slab, plan.kgroups
    pr = {
        "i0": bi * tile, "j0": bj * tile, "diag": bi == bj,
        "p_end": min((split + 1) * plan.rows, p),
    }
    p_begin = split * plan.rows
    steps = -(-(pr["p_end"] - p_begin) // slab)
    side = -(-f.shape[1] // tile)
    slot_floats = (1 if side == 1 else 2) * slab * tile
    slots = torch.full((plan.stages, slot_floats), float("nan"))
    mask, _ = _staged(pr["diag"])
    acc = [torch.zeros((tile, tile)) for _ in range(groups)]
    k_rows = slab // groups
    for s in range(steps):
        slot = slots[s % plan.stages]
        slot.fill_(float("nan"))     # what an earlier slab left is stale
        a_slab = slot[:slab * tile].view(slab, tile)
        b_slab = a_slab if pr["diag"] else slot[slab * tile:].view(
            slab, tile,
        )
        for kg in range(groups):
            # A k-group copies and reads its own rows of the slab.
            _land(slot, f, pr, p_begin + s * slab, plan, kg)
            rows = slice(kg * k_rows, (kg + 1) * k_rows)
            prod = a_slab[rows].T @ b_slab[rows]
            acc[kg] = acc[kg] + torch.where(mask, prod, 0.0)
    total = acc[0]
    for kg in range(1, groups):
        total = total + acc[kg]
    return total


def _sum_tiles(tiles: list[torch.Tensor]) -> torch.Tensor:
    out = torch.zeros((TILE, TILE))
    for t in tiles:
        out = out + t
    return out


def _walk(flat: torch.Tensor, norm: float, plan) -> tuple[torch.Tensor, ...]:
    """The kernel's computation for an ``(S, P, C)`` batch: ``(raw,
    G)``, block by block of the (pairs, splits, S) grid."""
    s_n, _, c = flat.shape
    tile = TILE
    side = -(-c // tile)
    raw = torch.full((s_n, c, c), float("nan"))
    g = torch.full((s_n, c, c), float("nan"))
    r, cc = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    for img in range(s_n):
        for bi in range(side):
            for bj in range(bi, side):
                parts = [
                    _block(plan, flat[img], bi, bj, q)
                    for q in range(plan.splits)
                ]
                groups = [
                    _sum_tiles(parts[gq * plan.group:(gq + 1) * plan.group])
                    for gq in range(plan.groups)
                ]
                # One group: its sum is the pair's (no second level).
                total = (
                    groups[0] if plan.groups == 1
                    else _sum_tiles(groups)
                )
                i, j = bi * tile + r, bj * tile + cc
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


# (S, P, C, n_sm, scale): one diagonal pair with P ragged and 11
# splits in three groups; C = 96 (three pairs, channels past C zero)
# with six splits in one group; C = 4 (one padded tile); an active
# clamp; C = 160 (six pairs, the third tile ragged) in one split and in
# two; C = 128 (three pairs, both tiles whole) in five splits.
WALK_CASES = [
    (1, 1300, 64, 8, 1.0),
    (1, 700, 96, 16, 1.0),
    (1, 100, 4, N_SM, 1.0),
    (1, 640, 64, 2, 60.0),
    (1, 330, 160, 2, 1.0),
    (1, 600, 160, 8, 1.0),
    (1, 300, 128, 16, 1.0),
]


@pytest.mark.parametrize(("s", "p", "c", "n_sm", "scale"), WALK_CASES)
def test_walk_rebuilds_the_gram(s, p, c, n_sm, scale) -> None:
    flat = _features(p + c, s, p, c, scale)
    plan = gram.gram_plan(p, c, n_sm, "ieee")
    raw, g = _walk(flat, float(p * c), plan)
    raw_p, g_p = gram.gram_plain_batched(flat, CLAMP, float(p * c), "ieee")
    _close(raw, raw_p)
    _close(g, g_p)
    assert torch.equal(raw, raw.mT)


def test_walk_covers_every_path() -> None:
    """Rings of three and four, rows ragged against the slab, several
    groups and one (one level), diagonal and off-diagonal pairs, a
    padded tile, an active clamp."""
    plans = [gram.gram_plan(p, c, n, "ieee") for _, p, c, n, _ in WALK_CASES]
    assert {p.stages for p in plans} == {3, 4}
    assert any(p % plan.slab for (_, p, *_), plan
               in zip(WALK_CASES, plans, strict=True))
    assert max(p.groups for p in plans) > 2  # noqa: PLR2004
    assert min(p.groups for p in plans) == 1
    assert {p.pairs for p in plans} >= {1, 3, 6}
    assert any(c % 64 for _, _, c, *_ in WALK_CASES)
    big = _features(640 + 64, 1, 640, 64, 60.0)[0]
    assert float((big.T @ big).max()) > CLAMP


def test_walk_batch_is_each_image_alone() -> None:
    """The plan and the sums are per image: a batch's walk gives each
    image's walk alone, bit for bit."""
    flat = _features(5, 3, 330, 160)
    plan = gram.gram_plan(330, 160, 2, "ieee")
    raw, g = _walk(flat, 330.0 * 160, plan)
    for i in range(3):
        one_raw, one_g = _walk(flat[i:i + 1], 330.0 * 160, plan)
        assert torch.equal(raw[i], one_raw[0])
        assert torch.equal(g[i], one_g[0])


@pytest.mark.parametrize(("p", "c"), [(1300, 64), (330, 160)])
def test_walk_matches_the_pallas_gram(p, c) -> None:
    """The raw Gram is the JAX package's Pallas Gram (interpret mode,
    ``Precision.HIGHEST``) of the same features, within 1e-5."""
    flat = _features(7, 1, p, c)
    ref = np.asarray(_raw_gram(
        jnp.asarray(flat[0].numpy()), True, jax.lax.Precision.HIGHEST,
    ))
    raw, _ = _walk(flat, float(p * c), gram.gram_plan(p, c, 4, "ieee"))
    _close(raw[0], torch.from_numpy(ref.copy()))
    assert math.isfinite(float(raw.abs().max()))


def test_gram_parts_edits_still_apply() -> None:
    """``tools/gram_parts.py --mode ieee`` times copies of the IEEE
    kernel with its sum, then its products, cut out by editing its
    source: the edits kept for this file's kernel still find their
    text, and each copy differs from the last."""
    design = gram_parts.variants("ieee")
    assert design is gram_parts.IEEE_VARIANTS
    sources = [gram_parts._variant_source(edits, "ieee")  # noqa: SLF001
               for edits in design.values()]
    assert len(set(sources)) == len(sources)
    assert "(void)flag;" in sources[1]
    assert "acc = fmaf(a, b, acc);" not in sources[2]
