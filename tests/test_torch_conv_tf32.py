"""The TF32 conv kernel's launch plan and its tile walk, on the CPU.

``csrc/conv3x3_tf32.cu`` cannot run here, so its indexing is checked
here before it runs on a card:

- ``tf32_plan`` at every conv shape set the card's smoke script drives
  (512x512, 1024x1024, N = 4 at 512x512, the 2048x2048 warm-start
  level's first two convs, 1280x720, and VGG19's stack at 528x960), for
  the forward and the input gradient, masked and not: its shared
  memory fits, its tiles cover the output, the split over K at N = 4 is
  the split at N = 1, every layer but the 32x32 one reads A through
  descriptors (256-pixel tiles, or 128-pixel ones where those need no
  split over K), and only conv 0's forward (C_in = 3) gathers;
- a plain-PyTorch walk of a plan's tiles (:func:`_walk`), written with
  the kernel's own index formulas: the halo slab as TMA lands it (the
  128-byte swizzle), or the gathered slab with its stepped (tap,
  channel); the slab rounded to tf32 and masked once, in place, from
  the mask's box landed in its own buffer (the same offsets); each
  tap's start row, read through descriptors (base offset 0) or as the
  register fragments' swizzled offsets, both through an emulation of
  the address-based swizzle, so that a wrong phase shows; B's boxes;
  the K order, the split and its fixed-order sum, the epilogue. Ring
  slots never loaded are NaN, so a read of stale shared memory shows.
  It matches ``conv3x3_plain(mode="tf32")`` within 1e-5 of the output's
  largest magnitude at ragged shapes, C_in = 3 and C_out = 3, masked
  and not; its batch is bit-equal to each image's walk alone; and on
  single images it matches the JAX package's Pallas conv (interpret
  mode, HIGHEST) fed the same inputs rounded to tf32 with numpy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.ops.pallas_conv import (
    conv3x3_bias_relu as jax_conv,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import pack_stencil
from style_transfer_visualizer_tpu_torch.ops import conv3x3
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import (
    K_STEP,
    SMEM_LIMIT,
    Tf32Plan,
    tf32_plan,
)

N_SM = 132
RTOL = 1e-5
ROW_BYTES = 4 * K_STEP  # one swizzled row: 32 floats
# (H = W, C_in, C_out) of VGG19's convs up to layer 28 at 512x512.
CONV_512 = [
    (512, 3, 64), (512, 64, 64), (256, 64, 128), (256, 128, 128),
    (128, 128, 256), (128, 256, 256), (64, 256, 512), (64, 512, 512),
    (32, 512, 512),
]


def _shape_sets() -> dict[str, list[tuple[int, int, int, int, int]]]:
    """``(n, h, w, C_in, C_out)`` of each shape set, by name."""
    return {
        "512": [(1, s, s, ci, co) for s, ci, co in CONV_512],
        "1024": [(1, 2 * s, 2 * s, ci, co) for s, ci, co in CONV_512],
        "n4_512": [(4, s, s, ci, co) for s, ci, co in CONV_512],
        "level_2048": [(1, 2048, 2048, ci, co) for _, ci, co in CONV_512[:2]],
        "720p": [
            (1, 720 * s // 512, 1280 * s // 512, ci, co)
            for s, ci, co in CONV_512
        ],
        "528x960": [
            (2, 528 * s // 512, 960 * s // 512, ci, co)
            for s, ci, co in CONV_512
        ],
    }


def _driven() -> list[tuple[str, int, int, int, int, int, bool]]:
    """Every launch those sets make: the forward and the input gradient
    (the flipped conv, C_in and C_out swapped), masked or not."""
    out = []
    for key, shapes in _shape_sets().items():
        for n, h, w, ci, co in shapes:
            out.append((key, n, h, w, ci, co, False))
            for masked in (True, False):
                out.append((key, n, h, w, co, ci, masked))
    return out


@pytest.mark.parametrize(
    ("key", "n", "h", "w", "ci", "co", "masked"), _driven(),
)
def test_plan_at_every_driven_shape(key, n, h, w, ci, co, masked) -> None:
    plan = tf32_plan(n, h, w, ci, co, masked, N_SM)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.mask_slab == (masked and plan.halo)
    assert plan.smem_bytes == (
        1024 + (plan.a_stages + plan.mask_slab) * plan.a_slot_bytes
        + plan.b_stages * plan.bn * ROW_BYTES
        + 8 * (3 * plan.a_stages + 2 * plan.b_stages + 2) + 16
    )
    assert plan.a_stages >= 2 and plan.b_stages >= 4  # noqa: PT018, PLR2004
    assert plan.a_slot_bytes % 1024 == 0
    assert plan.a_slot_bytes >= plan.slab_rows * ROW_BYTES
    assert plan.rows * plan.cols == plan.bm == 128 * plan.wm
    # The tiles cover the output: rows, columns, channels, images.
    tiles_y, tiles_x = -(-h // plan.rows), -(-w // plan.cols)
    ch_tiles = -(-co // plan.bn)
    assert tiles_y * plan.rows >= h > (tiles_y - 1) * plan.rows
    assert tiles_x * plan.cols >= w > (tiles_x - 1) * plan.cols
    assert ch_tiles * plan.bn >= co > (ch_tiles - 1) * plan.bn
    assert plan.tiles == n * tiles_y * tiles_x * ch_tiles
    assert 1 <= plan.blocks <= N_SM
    # K: every (tap, 32-channel slab) with a halo, else every K step.
    assert plan.k_pad == -(-9 * ci // K_STEP) * K_STEP
    assert plan.slabs * plan.taps * K_STEP == (
        9 * ci if plan.halo else plan.k_pad
    )
    assert (plan.splits - 1) * plan.split_slabs < plan.slabs
    assert plan.splits * plan.split_slabs >= plan.slabs
    # Which path: conv 0's forward gathers; every slab but the 32-wide
    # layer's is read through descriptors, on 64-wide tiles of 256
    # pixels, or 128 where those fill the card without a split.
    assert plan.halo == (ci != 3)  # noqa: PLR2004
    assert plan.ss == (plan.cols == 64 or not plan.halo)  # noqa: PLR2004
    assert plan.ss == (w > 32)  # noqa: PLR2004
    if plan.ss:
        wide = tf32_plan(n, h, w, ci, co, masked, N_SM, 2)
        narrow = tf32_plan(n, h, w, ci, co, masked, N_SM, 1)
        assert plan.wm == (1 if narrow.splits == 1 < wide.splits else 2)
    else:
        assert plan.wm == 1
    if key == "512" and ci == 3:  # noqa: PLR2004
        assert not plan.halo and plan.ss
    # Chosen per image: the batch's tile and split are one image's.
    alone = tf32_plan(1, h, w, ci, co, masked, N_SM)
    assert (plan.wm, plan.splits, plan.split_slabs) == (
        alone.wm, alone.splits, alone.split_slabs,
    )
    assert plan.tiles == n * alone.tiles


def test_small_layers_split_to_fill_the_card() -> None:
    """At 512x512 the 32x32 layer (register fragments, 128-pixel tiles)
    splits K four ways; the 64x64 layer's 128-pixel tiles fill the card
    unsplit where 256-pixel ones would split; its 256-channel one still
    splits; layers that fill the SMs do not split."""
    small = tf32_plan(1, 32, 32, 512, 512, False, N_SM)
    assert (small.ss, small.wm, small.tiles, small.splits) == (
        False, 1, 32, 4,
    )
    mid = tf32_plan(1, 64, 64, 512, 512, False, N_SM)
    assert (mid.ss, mid.wm, mid.tiles, mid.splits) == (True, 1, 128, 1)
    assert tf32_plan(1, 64, 64, 512, 512, False, N_SM, 2).splits == 2  # noqa: PLR2004
    out256 = tf32_plan(1, 64, 64, 512, 256, False, N_SM)
    assert (out256.wm, out256.tiles, out256.splits) == (2, 32, 4)
    assert tf32_plan(1, 128, 128, 256, 256, False, N_SM).splits == 1
    assert tf32_plan(4, 32, 32, 512, 512, True, N_SM).splits == small.splits


def test_plan_refuses_what_has_no_kernel() -> None:
    with pytest.raises(ValueError, match="no kernel"):
        tf32_plan(1, 32, 32, 512, 512, False, N_SM, 2)   # RS at 256 px
    with pytest.raises(ValueError, match="no kernel"):
        tf32_plan(1, 64, 64, 64, 64, False, N_SM, 4)


# ---- the walk: shared memory as bytes, and the 128-byte swizzle


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _swizzled(byte_addr: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle of a 1024-byte-aligned buffer, a function of
    the address: 16-byte chunk bits 4-6 XOR row bits 7-9."""
    return byte_addr ^ (((byte_addr >> 7) & 7) << 4)


def swz(row, col):
    """The kernel's ``swz``: float offset of (row, col) of a swizzled
    tile whose rows hold 32 floats."""
    row, col = np.asarray(row), np.asarray(col)
    return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3)


def _desc_read(buf: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """What a ``wgmma`` reads through a K-major descriptor (128-byte
    swizzle, 8-row groups 1024 bytes apart, base offset 0) starting
    ``start`` bytes into ``buf``: ``rows`` x 8 tf32 values."""
    i = np.arange(rows)[:, None]
    j = np.arange(8)[None, :]
    pre = start + (i // 8) * 1024 + (i % 8) * ROW_BYTES + 4 * j
    return buf[_t(_swizzled(pre) // 4)]


def test_swizzle_emulation_is_the_kernels() -> None:
    """``swz`` is the address swizzle on a 1024-byte-aligned base, and a
    descriptor started at any row reads that row's logical columns: the
    phase comes from the address, with the base offset left at 0. A
    descriptor that put the row's phase in the base offset as well (the
    offset applied on top of the address) would read other chunks."""
    rows, col = np.arange(64)[:, None], np.arange(32)[None, :]
    assert np.array_equal(
        swz(rows, col) * 4, _swizzled(rows * ROW_BYTES + col * 4),
    )
    buf = torch.arange(96 * 32, dtype=torch.float32)
    logical = torch.empty_like(buf)
    r, c = np.divmod(np.arange(96 * 32), 32)
    logical[_t(swz(r, c))] = buf            # logical (r, c) holds r*32+c
    for s0 in (0, 1, 3, 7, 13, 30):
        for kk in range(4):
            got = _desc_read(logical, s0 * ROW_BYTES + 32 * kk, 64)
            want = (
                (s0 + np.arange(64))[:, None] * 32 + 8 * kk + np.arange(8)
            )
            assert torch.equal(got, _t(want).float())
            if s0 % 8:
                phase = (s0 & 7) << 4
                i = np.arange(64)[:, None]
                pre = s0 * ROW_BYTES + 32 * kk + i * ROW_BYTES
                pre = pre + 4 * np.arange(8)[None, :]
                wrong = logical[_t((_swizzled(pre) ^ phase) // 4)]
                assert not torch.equal(wrong, got)


def _round(t: torch.Tensor) -> torch.Tensor:
    return conv3x3.round_tf32(t)


def _land_halo(plan, x, tile, c, slot) -> None:
    """TMA's box (1, rows + 2, cols + 2, 32) of x at (y0 - 1, x0 - 1),
    channels 32c.., into ``slot``: element (r = yy * pitch + xx, ch) at
    the address swizzle of ``r * 128 + 4 * ch``; zero outside."""
    _, h, w, _ = x.shape
    img, y0, x0, _ = tile
    r, ch = np.divmod(np.arange(plan.slab_rows * 32), 32)
    yy, xx = np.divmod(r, plan.pitch)
    y, xs = y0 - 1 + yy, x0 - 1 + xx
    ok = (y >= 0) & (y < h) & (xs >= 0) & (xs < w)
    vals = x[img][_t(np.clip(y, 0, h - 1)), _t(np.clip(xs, 0, w - 1)),
                  _t(32 * c + ch)]
    slot[_t(_swizzled(r * ROW_BYTES + 4 * ch) // 4)] = torch.where(
        _t(ok), vals, torch.tensor(0.0),
    )


def _prepare_halo(plan, mask_buf, slot) -> None:
    """``round_slab``: preparer p takes 16-byte chunk p % 8 of rows
    p / 8, p / 8 + 12, ...; zeroed where the landed mask (the same box,
    the same offsets) is <= 0; rounded in place."""
    seen = np.zeros(plan.slab_rows * 8, dtype=int)
    for p in range(conv3x3.TF32_PREPARERS):
        r = np.arange(p >> 3, plan.slab_rows, conv3x3.TF32_PREPARERS // 8)
        seen[r * 8 + (p & 7)] += 1
        at = _t((r * 32)[:, None] + 4 * (p & 7) + np.arange(4)[None, :])
        v = slot[at]
        if mask_buf is not None:
            v = torch.where(mask_buf[at] > 0, v, torch.tensor(0.0))
        slot[at] = _round(v)
    assert (seen == 1).all()   # every chunk once


def _gather(plan, x, mask, tile, c, slot) -> None:
    """``gather``: preparer p takes pixels p, p + 96, ...; K step c's
    32 values each, (tap, channel) stepped from k0 = 32c; masked,
    rounded, stored at ``swz(m, k)``."""
    _, h, w, cin = x.shape
    img, y0, x0, _ = tile
    k0 = c * K_STEP
    tap0 = k0 // cin
    ch0 = k0 - tap0 * cin
    taps, chans = [], []
    tap, ch = tap0, ch0
    for _ in range(K_STEP):       # the stepping, not a divide per k
        taps.append(tap)
        chans.append(ch)
        ch += 1
        if ch == cin:
            ch, tap = 0, tap + 1
    taps, chans = np.array(taps), np.array(chans)
    m = np.arange(plan.bm)
    assert sorted(
        mm for p in range(conv3x3.TF32_PREPARERS)
        for mm in range(p, plan.bm, conv3x3.TF32_PREPARERS)
    ) == m.tolist()
    dy = taps // 3
    y = (y0 + m // plan.cols - 1)[:, None] + dy[None, :]
    xs = (x0 + m % plan.cols - 1)[:, None] + (taps - 3 * dy)[None, :]
    ok = ((k0 + np.arange(K_STEP) < 9 * cin)[None, :] & (y >= 0) & (y < h)
          & (xs >= 0) & (xs < w))
    idx = (_t(np.clip(y, 0, h - 1)), _t(np.clip(xs, 0, w - 1)),
           _t(np.broadcast_to(np.minimum(chans, cin - 1), y.shape)))
    v = torch.where(_t(ok), x[img][idx], torch.tensor(0.0))
    if mask is not None:
        v = torch.where(_t(ok) & (mask[img][idx] > 0), v, torch.tensor(0.0))
    slot[_t(swz(m[:, None], np.arange(K_STEP)[None, :]))] = _round(v)


def _land_b(plan, hi, k0, n0, bslot) -> None:
    """TMA's 32 x bn box of the packed hi stencil at (k0, n0): row n
    (output channel n0 + n), zero past C_out."""
    cout = hi.shape[0]
    n, k = np.divmod(np.arange(plan.bn * 32), 32)
    ok = n0 + n < cout
    vals = hi[_t(np.minimum(n0 + n, cout - 1)), _t(k0 + k)]
    bslot[_t(_swizzled(n * ROW_BYTES + 4 * k) // 4)] = torch.where(
        _t(ok), vals, torch.tensor(0.0),
    )


def _walk(x, w9, b, relu, mask, plan: Tf32Plan) -> torch.Tensor:
    """The kernel's computation, work item by work item, in plain
    PyTorch: slots persist across items as the kernel's rings do."""
    n, h, w, cin = x.shape
    cout = w9.shape[2]
    hi = pack_stencil(w9)[0]
    assert hi.shape == (cout, plan.k_pad)
    pitch = plan.pitch
    tiles_y, tiles_x = -(-h // plan.rows), -(-w // plan.cols)
    ch_tiles = -(-cout // plan.bn)
    assert plan.tiles == n * tiles_y * tiles_x * ch_tiles

    def slab_row(m):
        return (m // plan.cols) * pitch + m % plan.cols if plan.halo else m

    # Thread t of warpgroup wg: accumulator rows 16 (t // 32) + (t % 32)
    # // 4 (+ 8) of each 64-pixel sub-tile, which starts at tile pixel
    # wg * 64 * wm + sub * 64.
    t = np.arange(128)
    frag_rows = np.unique(np.concatenate([
        16 * (t // 32) + (t % 32) // 4, 16 * (t // 32) + (t % 32) // 4 + 8,
    ]))
    assert frag_rows.tolist() == list(range(64))
    subs = [wg * 64 * plan.wm + s * 64
            for wg in range(2) for s in range(plan.wm)]
    a_slots = torch.full(
        (plan.a_stages, plan.a_slot_bytes // 4), float("nan"),
    )
    mask_buf = (
        torch.full((plan.a_slot_bytes // 4,), float("nan"))
        if plan.mask_slab else None
    )
    b_slots = torch.full((plan.b_stages, plan.bn * 32), float("nan"))
    out = torch.full((n, h, w, cout), float("nan"))
    written = torch.zeros((n, h, w, cout), dtype=torch.int32)
    ws: dict[int, torch.Tensor] = {}
    ca = cb = 0
    for item in range(plan.tiles * plan.splits):
        tile_i, q = divmod(item, plan.splits)
        ch_t, rest = tile_i % ch_tiles, tile_i // ch_tiles
        tx, rest = rest % tiles_x, rest // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        tile = (img, ty * plan.rows, tx * plan.cols, ch_t * plan.bn)
        c0 = q * plan.split_slabs
        acc = torch.zeros((plan.bm, plan.bn))
        for c in range(c0, min(plan.slabs, c0 + plan.split_slabs)):
            slot = a_slots[ca % plan.a_stages]
            ca += 1
            if plan.halo:
                _land_halo(plan, x, tile, c, slot)
                if mask_buf is not None:
                    _land_halo(plan, mask, tile, c, mask_buf)
                _prepare_halo(plan, mask_buf, slot)
            else:
                _gather(plan, x, mask, tile, c, slot)
            for tap in range(plan.taps):
                bslot = b_slots[cb % plan.b_stages]
                cb += 1
                k0 = tap * cin + c * K_STEP if plan.halo else c * K_STEP
                _land_b(plan, hi, k0, tile[3], bslot)
                shift = (tap // 3) * pitch + tap % 3 if plan.halo else 0
                bmat = torch.cat([
                    _desc_read(bslot, 32 * kk, plan.bn) for kk in range(4)
                ], dim=1)
                for m0 in subs:
                    if plan.ss:   # a descriptor at the tap's first row
                        start = (slab_row(m0) + shift) * ROW_BYTES
                        amat = torch.cat([
                            _desc_read(slot, start + 32 * kk, 64)
                            for kk in range(4)
                        ], dim=1)
                    else:         # each pixel's fragments, swizzled
                        rows = np.array([slab_row(m0 + r) for r in range(64)])
                        amat = slot[_t(swz(
                            rows[:, None] + shift, np.arange(32)[None, :],
                        ))]
                    acc[m0:m0 + 64] += amat @ bmat.T
        if plan.splits > 1:
            ws[item] = acc
            if len([k for k in ws if k // plan.splits == tile_i]) < (
                plan.splits
            ):
                continue
            acc = torch.zeros((plan.bm, plan.bn))
            for qq in range(plan.splits):   # split order
                acc = acc + ws[tile_i * plan.splits + qq]
        img, y0, x0, n0 = tile
        m = np.arange(plan.bm)
        y, xs = y0 + m // plan.cols, x0 + m % plan.cols
        o = n0 + np.arange(plan.bn)
        sel = _t((y < h)[:, None] & (xs < w)[:, None] & (o < cout)[None, :])
        yy = _t(np.broadcast_to(y[:, None], sel.shape))[sel]
        xx = _t(np.broadcast_to(xs[:, None], sel.shape))[sel]
        oo = _t(np.broadcast_to(o[None, :], sel.shape))[sel]
        v = acc[sel]
        if b is not None:
            v = v + b[oo]
        if relu:
            v = torch.relu(v)
        out[img, yy, xx, oo] = v
        written.index_put_(
            (torch.full_like(yy, img), yy, xx, oo),
            torch.ones_like(yy, dtype=torch.int32), accumulate=True,
        )
    assert torch.equal(written, torch.ones_like(written))
    return out


def _case(seed, n, h, w, ci, co, masked):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h, w, ci)).astype(np.float32))
    w9 = torch.from_numpy(
        (rng.normal(size=(9, ci, co)) * (2.0 / (9 * ci)) ** 0.5).astype(
            np.float32,
        ),
    )
    b = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32))
    mask = (
        torch.from_numpy(rng.normal(size=(n, h, w, ci)).astype(np.float32))
        if masked else None
    )
    return x, w9, b, mask


def _close(ours: torch.Tensor, ref: torch.Tensor) -> None:
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((ours - ref).abs().max())
    assert err <= RTOL * scale, (err, scale)


# (n, h, w, C_in, C_out, masked, n_sm): conv 0's gather (C_in = 3, 256
# pixels, ragged); a gathered odd C_in over two K steps; descriptors on
# 64-wide tiles of 256 pixels (ragged, C_out = 3 and 70), masked; and
# of 128 pixels (n_sm 4, where 256 would split); register fragments on
# narrow tiles (cols 16, 32), masked, with a split over K (C_in = 64,
# one tile an image); a split on the descriptor path (n_sm 8).
WALK_CASES = [
    (1, 9, 13, 3, 20, False, N_SM),
    (2, 5, 70, 3, 64, False, N_SM),
    (1, 6, 9, 5, 8, True, N_SM),
    (1, 5, 70, 32, 3, True, N_SM),
    (1, 7, 40, 32, 70, False, N_SM),
    (1, 8, 64, 64, 8, True, 4),
    (2, 9, 12, 64, 8, True, N_SM),
    (1, 11, 20, 32, 16, True, N_SM),
    (1, 3, 66, 64, 24, True, 8),
]


@pytest.mark.parametrize(
    ("n", "h", "w", "ci", "co", "masked", "n_sm"), WALK_CASES,
)
@pytest.mark.parametrize("relu", [True, False])
def test_walk_rebuilds_the_conv(n, h, w, ci, co, masked, n_sm, relu) -> None:
    x, w9, b, mask = _case(ci * 7 + co, n, h, w, ci, co, masked)
    plan = tf32_plan(n, h, w, ci, co, masked, n_sm)
    bias = None if masked else b   # the masked launch is the backward's
    ours = _walk(x, w9, bias, relu, mask, plan)
    ref = conv3x3.conv3x3_plain(x, w9, bias, relu, mask, mode="tf32")
    _close(ours, ref)


def test_walk_covers_every_path() -> None:
    """The cases reach the gather (one and two K steps), descriptors on
    256- and 128-pixel tiles, register fragments, the mask buffer, every
    B width, and splits on both read paths."""
    plans = [
        tf32_plan(n, h, w, ci, co, masked, n_sm)
        for n, h, w, ci, co, masked, n_sm in WALK_CASES
    ]
    assert {(p.halo, p.ss, p.wm) for p in plans} == {
        (False, True, 2), (True, True, 2), (True, True, 1), (True, False, 1),
    }
    assert {p.mask_slab for p in plans} == {True, False}
    assert {p.slabs for p in plans if not p.halo} == {1, 2}
    assert {p.bn for p in plans} == {8, 64, 128}
    assert {p.ss for p in plans if p.splits > 1} == {True, False}


@pytest.mark.parametrize(("n", "h", "w", "ci", "co", "masked", "n_sm"), [
    (2, 5, 70, 3, 64, False, N_SM), (2, 9, 12, 64, 8, True, N_SM),
    (3, 3, 66, 64, 24, True, 8),
])
def test_walk_batch_is_each_image_alone(n, h, w, ci, co, masked, n_sm) -> None:
    """The K order and the split are per image: a batch's walk gives
    each image's walk alone, bit for bit."""
    x, w9, b, mask = _case(3, n, h, w, ci, co, masked)
    plan = tf32_plan(n, h, w, ci, co, masked, n_sm)
    one = tf32_plan(1, h, w, ci, co, masked, n_sm)
    assert plan.splits > 1 or ci == 3  # noqa: PLR2004
    batch = _walk(x, w9, b, True, mask, plan)
    for i in range(n):
        alone = _walk(
            x[i:i + 1], w9, b, True, None if mask is None else mask[i:i + 1],
            one,
        )
        assert torch.equal(batch[i], alone[0])


def _np_tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to tf32 (nearest, ties away) on the bits."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32,
    )


@pytest.mark.parametrize(
    ("h", "w", "ci", "co"), [(9, 13, 3, 20), (5, 70, 32, 24)],
)
@pytest.mark.parametrize("relu", [True, False])
def test_walk_matches_the_pallas_conv(h, w, ci, co, relu) -> None:
    """On one image, the walk is the JAX package's Pallas conv
    (interpret mode, ``Precision.HIGHEST``) of the inputs rounded to
    tf32 with numpy, within 1e-5."""
    x, w9, b, _ = _case(11, 1, h, w, ci, co, False)
    ref = np.asarray(jax_conv(
        jnp.asarray(_np_tf32(x.numpy())), jnp.asarray(_np_tf32(w9.numpy())),
        jnp.asarray(b.numpy()), relu, True, jax.lax.Precision.HIGHEST,
    ))
    ours = _walk(
        x, w9, b, relu, None, tf32_plan(1, h, w, ci, co, False, N_SM),
    )
    _close(ours, torch.from_numpy(ref.copy()))
