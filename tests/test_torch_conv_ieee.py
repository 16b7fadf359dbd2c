"""The IEEE fp32 conv kernel's launch plan and its tile walk, on the CPU.

``csrc/conv3x3_ieee.cu`` cannot run here, so its indexing is checked
here before it runs on a card:

- ``ieee_plan`` at every conv shape set the card's smoke script drives
  (512x512, 1024x1024, N = 4 at 512x512, the 2048x2048 warm-start
  level's first two convs, 1280x720, and VGG19's stack at 528x960), for
  the forward and the input gradient (masked and not): its shared
  memory fits, its tiles cover the output, ``C_out <= 8`` gets the
  narrow tile, ``C_in = 3`` one chunk of one channel quad (K = 36, 27
  of them real), and the split over K at N = 4 is the split at N = 1;
- a plain-PyTorch walk of a plan's tiles (:func:`_walk`), written with
  the kernel's own index formulas: the thread map, the halo slab cut
  with zero fill (outside the image and beyond C_in), each tap's shift
  into the slab, the mask from its own slab, B's rows, the K order,
  the split and its fixed-order sum, the epilogue. Stage slots never
  loaded are NaN, so a read the kernel would make of stale shared
  memory shows. It matches ``conv3x3_plain`` within 1e-5 of the
  output's largest magnitude (it sums in another order) at ragged
  shapes (H, W not multiples of the tile), C_in = 3 and C_out = 3,
  masked and not; its batch is bit-equal to each image's walk alone;
  and on single images it matches the JAX package's Pallas conv
  (interpret mode, HIGHEST).
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
from style_transfer_visualizer_tpu_torch.models.arch import VGG19
from style_transfer_visualizer_tpu_torch.ops import conv3x3
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import (
    IEEE_BK,
    SMEM_LIMIT,
    IeeePlan,
    ieee_plan,
)

N_SM = 132
RTOL = 1e-5
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
    """Every launch those sets make: the forward and the input
    gradient (the flipped conv, C_in and C_out swapped), masked or not."""
    out = []
    for key, shapes in _shape_sets().items():
        for n, h, w, ci, co in shapes:
            out.append((key, n, h, w, ci, co, False))
            for masked in (True, False):
                out.append((key, n, h, w, co, ci, masked))
    return out


def test_vgg19_shapes_are_the_stack() -> None:
    pools, seen = 0, []
    for kind, ci, co in VGG19.layer_table[:29]:
        if kind == "pool":
            pools += 1
        elif kind == "conv":
            seen.append((512 >> pools, ci, co))
    assert sorted(set(seen)) == sorted(set(CONV_512))


@pytest.mark.parametrize(
    ("key", "n", "h", "w", "ci", "co", "masked"), _driven(),
)
def test_plan_at_every_driven_shape(key, n, h, w, ci, co, masked) -> None:
    del key
    plan = ieee_plan(n, h, w, ci, co, masked, N_SM)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == plan.stages * plan.stage_floats * 4 + 16
    assert 2 <= plan.stages <= 3  # noqa: PLR2004 - the kernel's waits
    assert plan.threads == conv3x3.IEEE_BLOCKS[plan.bn]
    assert plan.rows * plan.cols == plan.bm == plan.threads * 64 // plan.bn
    # A thread's 8 pixels are 8 rows of one column.
    assert plan.rows % 8 == 0
    # The tiles cover the output: rows, columns, channels, images.
    tiles_y, tiles_x = -(-h // plan.rows), -(-w // plan.cols)
    ch_tiles = -(-co // plan.bn)
    assert tiles_y * plan.rows >= h > (tiles_y - 1) * plan.rows
    assert tiles_x * plan.cols >= w > (tiles_x - 1) * plan.cols
    assert plan.tiles == n * tiles_y * tiles_x * ch_tiles
    assert plan.blocks == plan.tiles * plan.splits
    # The split covers K once, in at most `splits` ranges.
    assert (plan.splits - 1) * plan.split_chunks < plan.chunks
    assert plan.splits * plan.split_chunks >= plan.chunks
    # The narrow tile for C_out <= 8; for C_in = 3 one chunk of one
    # channel quad (36 K steps, 27 real), else chunks of two quads.
    assert (plan.bn == 8) == (co <= 8)  # noqa: PLR2004
    if ci == 3:  # noqa: PLR2004
        assert (plan.quads, plan.chunks) == (1, 1)
    else:
        assert plan.quads == IEEE_BK // 4
        assert plan.chunks == ci // IEEE_BK
    # The stage's parts do not overlap.
    a_floats = 4 * plan.quads * plan.slab_px
    assert plan.slab_px >= (plan.rows + 2) * (plan.cols + 2)
    assert plan.b_off >= (2 if masked else 1) * a_floats
    assert plan.stage_floats >= plan.b_off + 9 * IEEE_BK * plan.bn
    # Chosen per image: the batch's split is one image's.
    alone = ieee_plan(1, h, w, ci, co, masked, N_SM)
    assert (plan.splits, plan.split_chunks) == (
        alone.splits, alone.split_chunks,
    )
    assert plan.tiles == n * alone.tiles


def test_small_layers_split_to_fill_the_card() -> None:
    """At 512x512 the 32x32 layer's 32 tiles split K four ways (128
    blocks); layers that fill the SMs do not split."""
    small = ieee_plan(1, 32, 32, 512, 512, False, N_SM)
    assert (small.tiles, small.splits, small.blocks) == (32, 4, 128)
    big = ieee_plan(1, 128, 128, 256, 256, False, N_SM)
    assert big.splits == 1
    batch = ieee_plan(4, 32, 32, 512, 512, True, N_SM)
    assert batch.splits == small.splits


def test_plan_refuses_what_does_not_fit(monkeypatch) -> None:
    """A plan whose two stages overflow shared memory raises (there is
    no fallback): here a narrow masked slab against a shrunk limit."""
    monkeypatch.setattr(conv3x3, "SMEM_LIMIT", 4096)
    ieee_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="no ring of two"):
            ieee_plan(1, 1, 1, 8, 4, True, N_SM)
    finally:
        ieee_plan.cache_clear()


# ---- the walk


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _thread_map(bn: int, threads: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(tm, tn) of each thread and the pixel groups, as the kernel."""
    tns = bn // 8
    ln = min(tns, 8)
    lm = 32 // ln
    wm = (threads // 32) // (tns // ln)
    tid = np.arange(threads)
    lane, warp = tid % 32, tid // 32
    tm = (warp % wm) * lm + lane // ln
    return tm, (warp // wm) * ln + lane % ln, wm * lm


def _load_chunk(plan, x, mask, w9k, tile, ch, st) -> None:
    """``load_chunk`` and ``mask_chunk``: one K chunk into stage ``st``.

    Element (slab pixel p, channel slot k) of the chunk's
    ``4 * quads`` slots lands at ``((k // 4) * slab_px + p) * 4 + k % 4``,
    zero outside the image or beyond C_in; B row ``tap * IEEE_BK + k``
    is stencil row ``tap * C_in + c0 + k``, zero beyond C_in or C_out.
    """
    _, h, w, cin = x.shape
    cout = w9k.shape[1]
    img, y0, x0, n0 = tile
    zero = torch.tensor(0.0)
    slots = 4 * plan.quads
    c0 = ch * slots
    pitch = plan.cols + 2
    e = np.arange(slots * (plan.rows + 2) * pitch)
    p, k = e // slots, e % slots
    y, xx = y0 - 1 + p // pitch, x0 - 1 + p % pitch
    ok = _t((y >= 0) & (y < h) & (xx >= 0) & (xx < w) & (c0 + k < cin))
    src = (
        _t(np.clip(y, 0, h - 1)), _t(np.clip(xx, 0, w - 1)),
        _t(np.minimum(c0 + k, cin - 1)),
    )
    dst = _t(((k // 4) * plan.slab_px + p) * 4 + k % 4)
    st[dst] = torch.where(ok, x[img][src], zero)
    if mask is not None:
        st[plan.mask_off + dst] = torch.where(ok, mask[img][src], zero)
        st[dst] = torch.where(st[plan.mask_off + dst] > 0, st[dst], zero)
    tap, kk = np.divmod(np.arange(9 * slots), slots)
    r = (tap * IEEE_BK + kk)[:, None]
    grow = (tap * cin + c0 + kk)[:, None]
    o = n0 + np.arange(plan.bn)[None, :]
    ok = _t((c0 + kk < cin)[:, None] & (o < cout))
    vals = w9k[_t(np.minimum(grow, 9 * cin - 1)), _t(np.minimum(o, cout - 1))]
    st[plan.b_off + _t((r * plan.bn + np.arange(plan.bn)).ravel())] = (
        torch.where(ok, vals, zero).ravel()
    )


def _walk(x, w9, b, relu, mask, plan: IeeePlan) -> torch.Tensor:
    """The kernel's computation, tile by tile, in plain PyTorch."""
    n, h, w, cin = x.shape
    cout = w9.shape[2]
    w9k = w9.reshape(9 * cin, cout)
    tm, tn, tms = _thread_map(plan.bn, plan.threads)
    assert len(set(zip(tm.tolist(), tn.tolist(), strict=True))) == plan.threads
    assert tms * 8 == plan.bm
    # Thread tm holds column tm % cols, rows 8 * (tm // cols) + i.
    assert plan.rows % 8 == 0
    rows = 8 * (tm // plan.cols)[:, None] + np.arange(8)[None, :]
    cols = np.broadcast_to((tm % plan.cols)[:, None], rows.shape)
    pos = rows * (plan.cols + 2) + cols                    # (threads, 8)
    o_local = np.concatenate(
        [4 * tn[:, None] + np.arange(4), plan.bn // 2 + 4 * tn[:, None]
         + np.arange(4)], axis=1,
    )                                                      # (threads, 8)
    tiles_y, tiles_x = -(-h // plan.rows), -(-w // plan.cols)
    ch_tiles = -(-cout // plan.bn)
    assert plan.tiles == n * tiles_y * tiles_x * ch_tiles
    out = torch.full((n, h, w, cout), float("nan"))
    written = torch.zeros((n, h, w, cout), dtype=torch.int32)
    for t in range(plan.tiles):
        ch_t, rest = t % ch_tiles, t // ch_tiles
        tx, rest = rest % tiles_x, rest // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        tile = (img, ty * plan.rows, tx * plan.cols, ch_t * plan.bn)
        partials = []
        for q in range(plan.splits):
            k0 = q * plan.split_chunks
            acc = torch.zeros((plan.threads, 8, 8))
            for ch in range(k0, min(plan.chunks, k0 + plan.split_chunks)):
                st = torch.full((plan.stage_floats,), float("nan"))
                _load_chunk(plan, x, mask, w9k, tile, ch, st)
                a4 = st[:4 * plan.quads * plan.slab_px].reshape(
                    plan.quads, plan.slab_px, 4,
                )
                b_floats = 9 * IEEE_BK * plan.bn
                bs = st[plan.b_off:plan.b_off + b_floats]
                bs = bs.reshape(9 * IEEE_BK, plan.bn)
                # K order: quad, tap column dx, tap row dy, channel.
                for qq in range(plan.quads):
                    for dx in range(3):
                        for dy in range(3):
                            av = a4[qq][_t(pos + dy * (plan.cols + 2) + dx)]
                            tap = dy * 3 + dx
                            for cc in range(4):
                                bv = bs[tap * IEEE_BK + qq * 4 + cc]
                                bv = bv[_t(o_local)]
                                acc = acc + av[:, :, cc, None] * bv[:, None, :]
            partials.append(acc)
        if plan.splits > 1:
            acc = torch.zeros((plan.threads, 8, 8))
            for part in partials:
                acc = acc + part
        img, y0, x0, n0 = tile
        shape = (plan.threads, 8, 8)
        yy = _t(np.broadcast_to((y0 + rows)[:, :, None], shape))
        xx = _t(np.broadcast_to((x0 + cols)[:, :, None], shape))
        oo = _t(np.broadcast_to((n0 + o_local)[:, None, :], shape))
        sel = (yy < h) & (xx < w) & (oo < cout)
        yy, xx, oo, v = yy[sel], xx[sel], oo[sel], acc[sel]
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


# (n, h, w, C_in, C_out, masked, n_sm): ragged against every tile
# shape; one channel quad a chunk (C_in = 3); chunks with zero slots
# (C_in = 6, 12, 62; 4-byte copies where C_in % 4 != 0); the narrow
# tile (C_out = 3, 8), the 64- and 128-channel tiles; two-way splits
# (C_in = 64 and 62, one tile an image).
WALK_CASES = [
    (1, 13, 11, 3, 20, False, N_SM),
    (2, 9, 14, 3, 130, True, N_SM),
    (1, 13, 11, 12, 72, True, N_SM),
    (1, 19, 21, 16, 3, True, N_SM),
    (2, 7, 30, 6, 3, False, N_SM),
    (1, 17, 10, 8, 64, True, N_SM),
    (2, 11, 13, 16, 136, False, N_SM),
    (1, 10, 9, 64, 40, True, N_SM),
    (2, 5, 6, 64, 8, True, 4),
    (1, 9, 7, 62, 24, True, N_SM),
]


@pytest.mark.parametrize(
    ("n", "h", "w", "ci", "co", "masked", "n_sm"), WALK_CASES,
)
@pytest.mark.parametrize("relu", [True, False])
def test_walk_rebuilds_the_conv(n, h, w, ci, co, masked, n_sm, relu) -> None:
    x, w9, b, mask = _case(ci * 7 + co, n, h, w, ci, co, masked)
    plan = ieee_plan(n, h, w, ci, co, masked, n_sm)
    bias = None if masked else b   # the masked launch is the backward's
    ours = _walk(x, w9, bias, relu, mask, plan)
    ref = conv3x3.conv3x3_plain(x, w9, bias, relu, mask)
    _close(ours, ref)


def test_walk_covers_every_path() -> None:
    """The cases above reach each tile width, one and two quads a
    chunk, 16- and 4-byte copies, and a split of each copy width."""
    plans = [ieee_plan(*case) for case in WALK_CASES]
    assert {p.bn for p in plans} == set(conv3x3.IEEE_BLOCKS)
    assert {p.quads for p in plans} == {1, 2}
    split_c_in = {case[3] % 4 == 0 for case, p in zip(
        WALK_CASES, plans, strict=True) if p.splits > 1}
    assert split_c_in == {True, False}
    assert any(p.cols > 16 for p in plans)  # noqa: PLR2004


@pytest.mark.parametrize(("n", "h", "w", "ci", "co", "masked", "n_sm"), [
    (2, 9, 14, 3, 130, True, N_SM), (2, 5, 6, 64, 8, True, 4),
    (3, 6, 5, 62, 16, False, N_SM),
])
def test_walk_batch_is_each_image_alone(n, h, w, ci, co, masked, n_sm) -> None:
    """The K order and the split are per image: a batch's walk gives
    each image's walk alone, bit for bit."""
    x, w9, b, mask = _case(3, n, h, w, ci, co, masked)
    plan = ieee_plan(n, h, w, ci, co, masked, n_sm)
    one = ieee_plan(1, h, w, ci, co, masked, n_sm)
    assert plan.splits > 1 or ci == 3  # noqa: PLR2004
    batch = _walk(x, w9, b, True, mask, plan)
    for i in range(n):
        alone = _walk(
            x[i:i + 1], w9, b, True, None if mask is None else mask[i:i + 1],
            one,
        )
        assert torch.equal(batch[i], alone[0])


@pytest.mark.parametrize(
    ("h", "w", "ci", "co"), [(13, 11, 3, 20), (10, 9, 16, 72)],
)
@pytest.mark.parametrize("relu", [True, False])
def test_walk_matches_the_pallas_conv(h, w, ci, co, relu) -> None:
    """On one image, the walk is the JAX package's Pallas conv
    (interpret mode, ``Precision.HIGHEST``) within 1e-5."""
    x, w9, b, _ = _case(11, 1, h, w, ci, co, False)
    ref = np.asarray(jax_conv(
        jnp.asarray(x.numpy()), jnp.asarray(w9.numpy()),
        jnp.asarray(b.numpy()), relu, True, jax.lax.Precision.HIGHEST,
    ))
    ours = _walk(x, w9, b, relu, None, ieee_plan(1, h, w, ci, co, False, N_SM))
    _close(ours, torch.from_numpy(ref.copy()))
