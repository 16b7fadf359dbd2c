"""The port's banded (row-tiled) evaluation vs the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package's
``ops/tiled.py`` (on the CPU, as ``tests/test_tiled.py`` runs it) and
the port's. Tolerances, each from float32 sums in other orders:

- ``receptive_margin``, ``validate_tiling`` (the same exception and
  message) and ``auto_tile_rows``: equal, over the VGG19 and VGG16
  tables, a grid of sizes, tap sets and budgets;
- ``tiled_total_loss`` on a tiny stack (2 pools, widths <= 16,
  heights 32-64): the loss within 1e-5 relative, the gradient within
  1e-4 of its largest magnitude, of the JAX package's tiled loss and
  of the port's whole-image loss;
- ``compute_tiled_targets`` in every tiled and untiled mix, and with
  no content layers: Grams within 1e-6 relative, features within 1e-5;
- ``main._resolve_tile_rows`` and the warm start's level decision
  equal to the JAX package's with its thresholds put in;
- the TOML key and the CLI flag: loaded as the JAX loader loads them;
- a banded L-BFGS run through ``main.style_transfer`` against the
  whole-image run, within the control (the whole run against itself
  from content perturbed by 1e-7 relative, the floor 1e-3), and the
  ``tile_rows=16`` run resumed from step 3 bit-equal to the
  uninterrupted one.
"""
from __future__ import annotations

import csv
import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu import config as jax_config
from style_transfer_visualizer_tpu import constants as jax_constants
from style_transfer_visualizer_tpu import main as jax_main
from style_transfer_visualizer_tpu.engine import coarse as jax_coarse
from style_transfer_visualizer_tpu.models import arch as jax_arch
from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.ops import tiled as jax_tiled
from style_transfer_visualizer_tpu_torch import cli, main
from style_transfer_visualizer_tpu_torch import config as port_config
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.engine import coarse
from style_transfer_visualizer_tpu_torch.engine.optimizers import StepAux
from style_transfer_visualizer_tpu_torch.engine.step import StepBundle
from style_transfer_visualizer_tpu_torch.models import arch, features, vgg19
from style_transfer_visualizer_tpu_torch.ops import gram, tiled
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu.utils.logging import logger as jax_logger

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAM_RTOL = 1e-6
FEAT_RTOL = 1e-5
CURVE_FLOOR = 1e-3
HIGHEST = jax.lax.Precision.HIGHEST
#: The tiny stack: convs (index, C_in, C_out); a pool after 3 and 8.
TINY_CONVS = ((0, 3, 8), (2, 8, 8), (5, 8, 16), (7, 16, 16), (10, 16, 16))
TAP_SETS = {
    "shallow": ((0, 5), (2,)),
    "deep": ((0, 5, 10), (7,)),
    "style_only": ((0, 7, 10), ()),
    "content_only": ((), (5, 10)),
}
VGG_TAPS = [
    (0, 5, 10, 19, 21, 28), (0, 5), (2,), (0, 5, 10, 17, 24, 19), (9,),
    (0, 4, 9, 18, 27), (),
]


def _tiny_host(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        idx: {
            "w": (
                rng.standard_normal((3, 3, ci, co)) * np.sqrt(2.0 / (9 * ci))
            ).astype(np.float32),
            "b": (0.1 * rng.standard_normal(co)).astype(np.float32),
        }
        for idx, ci, co in TINY_CONVS
    }


@pytest.fixture(scope="module")
def tiny():
    host = _tiny_host()
    jax_params = {
        i: {k: jnp.asarray(v) for k, v in layer.items()}
        for i, layer in host.items()
    }
    return jax_params, vgg19.params_from_numpy(host, "cpu")


def _image(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5, 1.5, size=(1, h, w, 3)).astype(np.float32)


def _targets(params, jparams, style, content, sl, cl):
    jt = jax_features.compute_targets(
        jparams, jnp.asarray(style), jnp.asarray(content), sl, cl,
        precision=HIGHEST,
    )
    pt = features.Targets(
        style_grams={
            k: torch.from_numpy(np.array(v))
            for k, v in jt.style_grams.items()
        },
        content_feats={
            k: torch.from_numpy(np.array(v))
            for k, v in jt.content_feats.items()
        },
    )
    return jt, pt


# --- the pure functions ---------------------------------------------------


@pytest.mark.parametrize("model", ["vgg19", "vgg16"])
@pytest.mark.parametrize("taps", VGG_TAPS)
def test_receptive_margin_matches_jax(model, taps) -> None:
    table = arch.get_architecture(model).layer_table
    jtable = jax_arch.get_architecture(model).layer_table
    if max(taps, default=0) >= len(table):
        pytest.skip(f"tap beyond {model}'s {len(table)} layers")
    assert tiled.receptive_margin(taps, table) == jax_tiled.receptive_margin(
        taps, jtable,
    )


def test_receptive_margin_default_taps() -> None:
    # convs 0,2 at scale 1 (2) + 5,7 at 2 (4) + 10..16 at 4 (16)
    # + 19..25 at 8 (32) + 28 at 16 (16) = 70, rounded up to 16 -> 80.
    assert tiled.receptive_margin((0, 5, 10, 19, 21, 28)) == (80, 16)
    assert tiled.receptive_margin(()) == (0, 1)


def _raised(fn, *args):
    try:
        fn(*args)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("taps", [(0, 5), (0, 5, 10, 19, 21, 28), (2,)])
@pytest.mark.parametrize(
    "height", [8, 33, 40, 64, 240, 1080, 2160, 4320],
)
def test_validate_tiling_matches_jax(taps, height) -> None:
    for tile_rows in (8, 16, 48, 100, 160, 432, 720, 1080, 2160):
        ours = _raised(tiled.validate_tiling, height, tile_rows, taps)
        ref = _raised(jax_tiled.validate_tiling, height, tile_rows, taps)
        assert ours == ref, (height, tile_rows, taps)


@pytest.mark.parametrize("model", ["vgg19", "vgg16"])
@pytest.mark.parametrize(
    "size",
    [(2160, 3840), (4320, 7680), (2048, 2048), (4096, 4096), (1080, 1920),
     (4104, 4104), (240, 64), (2000, 3000), (8640, 15360)],
)
def test_auto_tile_rows_matches_jax(model, size) -> None:
    table = arch.get_architecture(model).layer_table
    jtable = jax_arch.get_architecture(model).layer_table
    arch_ = arch.get_architecture(model)
    tap_sets = [
        tuple(sorted(
            set(arch_.default_style_layers)
            | set(arch_.default_content_layers),
        )),
        (0, 5), (2,),
    ]
    for taps, budget in itertools.product(
        tap_sets, (1_000_000, 1536 * 2048, 3_500_000, 8_000_000, 30_000_000),
    ):
        assert tiled.auto_tile_rows(
            *size, taps, max_band_pixels=budget, table=table,
        ) == jax_tiled.auto_tile_rows(
            *size, taps, max_band_pixels=budget, table=jtable,
        ), (size, taps, budget)


def test_band_windows_cover_every_row_once() -> None:
    for height, tile_rows, margin in ((64, 16, 12), (2160, 720, 80),
                                      (4320, 864, 80), (64, 32, 4)):
        windows = tiled.band_windows(height, tile_rows, margin)
        assert len(windows) == height // tile_rows
        for i, (start, offset) in enumerate(windows):
            assert 0 <= start <= height - tile_rows - 2 * margin
            assert start + offset == i * tile_rows
            assert offset >= min(margin, i * tile_rows)


# --- losses, gradients and targets on the tiny stack -----------------------


@pytest.mark.parametrize("taps", list(TAP_SETS))
@pytest.mark.parametrize(("height", "tile_rows"), [(64, 16), (64, 32),
                                                    (48, 16)])
@pytest.mark.parametrize("weights", [False, True])
def test_tiled_loss_and_grad_match_jax_and_whole(
    tiny, taps, height, tile_rows, weights,
) -> None:
    jparams, params = tiny
    sl, cl = TAP_SETS[taps]
    if tile_rows + 2 * tiled.receptive_margin(
        tuple(sorted(set(sl) | set(cl))),
        arch.layer_table_from_params(params),
    )[0] > height:
        pytest.skip("band with margins exceeds the height")
    content, style = _image(1, height, 32), _image(2, height, 32)
    x0 = _image(3, height, 32)
    jt, pt = _targets(params, jparams, style, content, sl, cl)
    sw = (1.0, 0.5, 0.25)[: len(sl)] if weights and sl else None

    def jax_loss(x):
        total, _ = jax_tiled.tiled_total_loss(
            jparams, x, jt, 100.0, 1.0, sl, cl, tile_rows, HIGHEST,
            style_weights=sw,
        )
        return total

    val_j, grad_j = jax.value_and_grad(jax_loss)(jnp.asarray(x0))
    results = []
    for fn in ("tiled", "whole"):
        x = torch.from_numpy(x0.copy()).requires_grad_(True)
        if fn == "tiled":
            total, _ = tiled.tiled_total_loss(
                params, x, pt, 100.0, 1.0, sl, cl, tile_rows,
                style_weights=sw,
            )
        else:
            total, _ = features.total_loss(
                params, x, pt, 100.0, 1.0, sl, cl, sw,
            )
        (g,) = torch.autograd.grad(total, x)
        results.append((float(total.detach()), g.numpy()))
    ref = np.asarray(grad_j)
    for value, grad in results:
        np.testing.assert_allclose(value, float(val_j), rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            grad, ref, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(ref).max(),
        )


def test_tiled_loss_without_grad_matches(tiny) -> None:
    """Under ``no_grad`` the bands run without checkpoints: same value."""
    jparams, params = tiny
    sl, cl = TAP_SETS["deep"]
    content, style = _image(4, 64, 32), _image(5, 64, 32)
    _, pt = _targets(params, jparams, style, content, sl, cl)
    x = torch.from_numpy(_image(6, 64, 32))
    with torch.no_grad():
        plain = tiled.tiled_total_loss(params, x, pt, 10.0, 1.0, sl, cl, 16)
    with torch.enable_grad():
        graded = tiled.tiled_total_loss(
            params, x.clone().requires_grad_(True), pt, 10.0, 1.0, sl, cl, 16,
        )
    assert torch.equal(plain[0], graded[0].detach())


@pytest.mark.parametrize("taps", ["shallow", "deep", "style_only"])
@pytest.mark.parametrize(
    ("rows_style", "rows_content"),
    [(None, None), (16, None), (None, 16), (16, 32), (32, 16)],
)
def test_tiled_targets_match_jax(tiny, taps, rows_style, rows_content) -> None:
    jparams, params = tiny
    sl, cl = TAP_SETS[taps]
    style, content = _image(7, 64, 48), _image(8, 64, 32)
    ref = jax_tiled.compute_tiled_targets(
        jparams, jnp.asarray(style), jnp.asarray(content), sl, cl,
        tile_rows_style=rows_style, tile_rows_content=rows_content,
        precision=HIGHEST,
    )
    ours = tiled.compute_tiled_targets(
        params, torch.from_numpy(style), torch.from_numpy(content), sl, cl,
        tile_rows_style=rows_style, tile_rows_content=rows_content,
    )
    assert sorted(ours.style_grams) == sorted(ref.style_grams)
    assert sorted(ours.content_feats) == sorted(ref.content_feats)
    for idx, g in ref.style_grams.items():
        np.testing.assert_allclose(
            ours.style_grams[idx].numpy(), np.asarray(g), rtol=GRAM_RTOL,
            atol=GRAM_RTOL * float(np.abs(np.asarray(g)).max()),
        )
    for idx, f in ref.content_feats.items():
        np.testing.assert_allclose(
            ours.content_feats[idx].numpy(), np.asarray(f), rtol=FEAT_RTOL,
            atol=FEAT_RTOL * float(np.abs(np.asarray(f)).max()),
        )


def test_gram_raw_is_the_unclamped_sum() -> None:
    rng = np.random.default_rng(9)
    f = torch.from_numpy(
        (1e3 * rng.standard_normal((1, 8, 6, 16))).astype(np.float32),
    ).requires_grad_(True)
    raw = gram.gram_raw(f)
    flat = f.detach().reshape(48, 16)
    assert torch.equal(raw.detach(), flat.T @ flat)
    assert float(raw.detach().max()) > 5e5  # past the clamp, unclamped
    dg = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    (grad,) = torch.autograd.grad(raw, f, dg)
    np.testing.assert_allclose(
        grad.reshape(48, 16).numpy(), (flat @ (dg + dg.T)).numpy(),
        rtol=1e-6, atol=1e-6 * float((flat @ (dg + dg.T)).abs().max()),
    )
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_raw(f.detach().transpose(1, 2))


# --- the resolvers against the JAX package's ------------------------------


def _jax_thresholds(monkeypatch) -> None:
    """The JAX package's thresholds and band budget, in the port."""
    for module in (main, coarse):
        for name in ("AUTO_TILE_PIXEL_THRESHOLD", "AUTO_REMAT_PIXEL_THRESHOLD",
                     "BATCH_AUTO_REMAT_PIXEL_THRESHOLD"):
            if hasattr(module, name):
                monkeypatch.setattr(
                    module, name, getattr(jax_constants, name),
                )
        monkeypatch.setattr(module, "MAX_BAND_PIXELS", 3_500_000)


def _configs(model: str, tile_rows: int):
    opt = {"model": model, "tile_rows": tile_rows}
    jax_cfg = jax_config.StyleTransferConfig.model_validate(
        {"optimization": opt, "hardware": {"device": "cpu"}},
    )
    port = StyleTransferConfig(
        optimization=OptimizationConfig(**opt),
        hardware=HardwareConfig(device="cpu"),
    )
    return jax_cfg, port


@pytest.mark.parametrize("model", ["vgg19", "vgg16"])
@pytest.mark.parametrize(
    "size",
    [(2160, 3840), (4320, 7680), (2048, 2048), (4096, 4096), (1080, 1920),
     (4104, 4104), (64, 64), (2400, 1800)],
)
def test_resolve_tile_rows_matches_jax(monkeypatch, caplog, model, size):
    _jax_thresholds(monkeypatch)
    for log in (logger, jax_logger):
        monkeypatch.setattr(log, "propagate", True)
        caplog.set_level(logging.INFO, logger=log.name)
    for tile_rows in (-1, 0, 16, 432, 720, 100, 864):
        jax_cfg, port = _configs(model, tile_rows)
        caplog.clear()
        try:
            want = jax_main._resolve_tile_rows(jax_cfg, *size)  # noqa: SLF001
        except ValueError as exc:
            with pytest.raises(ValueError) as ours:
                main._resolve_tile_rows(port, *size)  # noqa: SLF001
            assert str(ours.value) == str(exc)
            continue
        jax_logs = [r.getMessage() for r in caplog.records]
        caplog.clear()
        assert main._resolve_tile_rows(port, *size) == want  # noqa: SLF001
        assert [r.getMessage() for r in caplog.records] == jax_logs


def test_h100_thresholds_band_8k_and_not_4k() -> None:
    """At the port's own thresholds 4K UHD runs whole and 8K UHD in bands
    whose windows fit the band budget."""
    _, port = _configs("vgg19", -1)
    assert main._resolve_tile_rows(port, 2160, 3840) == 0  # noqa: SLF001
    rows = main._resolve_tile_rows(port, 4320, 7680)  # noqa: SLF001
    assert rows > 0
    margin, _ = tiled.receptive_margin((0, 5, 10, 19, 21, 28))
    assert (rows + 2 * margin) * 7680 <= main.MAX_BAND_PIXELS


def _stub_level(monkeypatch, module, seen: list, *, jax_side: bool):
    """Replace a level's targets and step with stubs that record the
    step builder's ``tile_rows`` and ``remat``."""

    def fake_targets(*args, **kwargs):
        return "targets"

    def fake_step(*args, **kwargs):
        seen.append((kwargs.get("tile_rows", 0), kwargs["remat"]))

        def chunked(image, state, k):
            loss = jnp.zeros((k,)) if jax_side else torch.zeros((k,))
            return image, state, StepAux(loss, loss, loss, loss)

        return StepBundle(None, None, chunked)

    if jax_side:
        from style_transfer_visualizer_tpu.engine import step as jax_step
        from style_transfer_visualizer_tpu.ops import tiled as jt

        monkeypatch.setattr(module, "compute_targets", fake_targets)
        monkeypatch.setattr(jt, "compute_tiled_targets", fake_targets)
        monkeypatch.setattr(jax_step, "build_update_step", fake_step)
    else:
        monkeypatch.setattr(module, "compute_targets", fake_targets)
        monkeypatch.setattr(module, "compute_tiled_targets", fake_targets)
        monkeypatch.setattr(module, "build_update_step", fake_step)


@pytest.mark.parametrize("taps", ["shallow", "deep"])
@pytest.mark.parametrize(("tile_rows", "remat"), [(-1, False), (0, False),
                                                  (-1, True), (0, True)])
def test_level_decision_matches_jax(monkeypatch, tiny, taps, tile_rows,
                                    remat) -> None:
    """Each level's (tile_rows, remat) as the JAX package's level picks
    them, with small thresholds in both packages so that levels of
    64x64 (4096 px) band, 32x64 rematerialize and 32x32 run plainly."""
    jparams, params = tiny
    sl, cl = TAP_SETS[taps]
    for module in (jax_coarse, coarse):
        monkeypatch.setattr(module, "AUTO_TILE_PIXEL_THRESHOLD", 4096)
        monkeypatch.setattr(module, "AUTO_REMAT_PIXEL_THRESHOLD", 2048)
    monkeypatch.setattr(coarse, "MAX_BAND_PIXELS", 3_500_000)
    seen_j: list = []
    seen_p: list = []
    _stub_level(monkeypatch, jax_coarse, seen_j, jax_side=True)
    _stub_level(monkeypatch, coarse, seen_p, jax_side=False)
    opt = {"style_layers": list(sl), "content_layers": list(cl),
           "tile_rows": tile_rows, "remat": remat, "lap_w": 0.0,
           "init_method": "content"}
    jax_cfg = jax_config.StyleTransferConfig.model_validate(
        {"optimization": opt, "hardware": {"device": "cpu"}},
    )
    port = StyleTransferConfig(
        optimization=OptimizationConfig(**opt),
        hardware=HardwareConfig(device="cpu"),
    )
    content = _image(10, 128, 128)
    for ch, cw in ((64, 64), (32, 64), (32, 32), (96, 64)):
        jax_coarse._optimize_level(  # noqa: SLF001
            jparams, jnp.asarray(content), jnp.asarray(content), jax_cfg,
            jax.random.key(0), ch, cw, 1, gram_backend="xla",
            conv_backend="xla", blend_imgs=None, start=None,
        )
        coarse._optimize_level(  # noqa: SLF001
            params, torch.from_numpy(content), torch.from_numpy(content),
            port, None, ch, cw, 1, blend_imgs=None, start=None,
        )
    assert seen_p == [(int(t), bool(r)) for t, r in seen_j]
    # 64x64 and 96x64 band unless tile_rows is 0; 32x64 rematerializes.
    assert bool(seen_p[0][0]) == (tile_rows != 0)
    assert seen_p[1] == (0, True)


def test_batch_level_remat_matches_jax(monkeypatch, tiny) -> None:
    """The batch's levels rematerialize by pixels x styles, the JAX
    package's ``_auto_remat_batched`` at the level."""
    _, params = tiny
    seen: list = []

    def fake_step(*args, **kwargs):
        seen.append(kwargs["remat"])

        def chunked(image, state, k):
            loss = torch.zeros((k, 2))
            return image, state, StepAux(loss, loss, loss, loss)

        return StepBundle(None, None, chunked)

    monkeypatch.setattr(coarse, "multi_style_targets", lambda *a, **k: None)
    monkeypatch.setattr(coarse, "build_multi_style_update", fake_step)
    monkeypatch.setattr(coarse, "BATCH_AUTO_REMAT_PIXEL_THRESHOLD", 4096)
    monkeypatch.setattr(
        jax_main, "BATCH_AUTO_REMAT_PIXEL_THRESHOLD", 4096,
    )
    config = StyleTransferConfig(
        optimization=OptimizationConfig(
            style_layers=[0, 5], content_layers=[2], coarse_steps=2,
            pyramid_levels=3, lap_w=0.0, init_method="content",
        ),
        hardware=HardwareConfig(device="cpu"),
    )
    img = torch.from_numpy(_image(11, 128, 128))
    coarse.multi_coarse_init(params, img, [img, img], config, None)
    assert seen == [
        jax_main._auto_remat_batched(h * w, 2)  # noqa: SLF001
        for h, w in coarse.pyramid_dims(128, 128, 3)
    ]
    assert seen == [False, True]


# --- config and CLI ---------------------------------------------------------


@pytest.mark.parametrize(
    "text",
    ["tile_rows = 432", "tile_rows = 0", "tile_rows = -1", "remat = true",
     "remat = false", "tile_rows = 16\nremat = true", "tile_rows = 720.0"],
)
def test_toml_keys_load_as_jax_loads_them(tmp_path, text) -> None:
    path = tmp_path / "c.toml"
    path.write_text(f'[optimization]\n{text}\n[hardware]\ndevice = "cpu"\n')
    ref = jax_config.ConfigLoader.load(str(path)).optimization
    ours = port_config.ConfigLoader.load(path).optimization
    assert (ours.tile_rows, ours.remat) == (ref.tile_rows, ref.remat)
    assert type(ours.tile_rows) is int


@pytest.mark.parametrize("text", ["tile_rows = -2", 'tile_rows = "x"',
                                  'remat = "maybe"'])
def test_bad_toml_values_raise_in_both(tmp_path, text) -> None:
    path = tmp_path / "c.toml"
    path.write_text(f"[optimization]\n{text}\n")
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        jax_config.ConfigLoader.load(str(path))
    with pytest.raises(ValueError):  # noqa: PT011
        port_config.ConfigLoader.load(path)


@pytest.mark.parametrize(
    "argv",
    [[], ["--remat"], ["--tile-rows", "432"], ["--tile-rows", "0"],
     ["--tile-rows", "-1", "--remat"]],
)
def test_cli_flags_merge_as_jax_merges_them(argv) -> None:
    from style_transfer_visualizer_tpu import cli as jax_cli

    base = ["--content", "c.png", "--style", "s.png", "--device", "cpu"]
    ref = jax_config.build_config_from_cli(
        vars(jax_cli.build_arg_parser().parse_args([*base, *argv])),
    ).optimization
    ours = cli.config_from_args(
        cli.build_parser().parse_args([*base, *argv]),
    ).optimization
    assert (ours.tile_rows, ours.remat) == (ref.tile_rows, ref.remat)


def test_cli_refuses_a_negative_band_height() -> None:
    with pytest.raises(SystemExit):
        cli.main(["--content", "c.png", "--style", "s.png",
                  "--tile-rows", "-2"])


def test_help_states_the_h100_thresholds() -> None:
    text = " ".join(cli.build_parser().format_help().split())
    assert f"{main.AUTO_TILE_PIXEL_THRESHOLD:,} px" in text
    assert "~4MP" not in text


# --- banded runs end to end -------------------------------------------------


@pytest.fixture
def images(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(40)
    paths = {}
    for name in ("content", "style"):
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


def _run_config(out, tile_rows: int, steps: int = 6, **output):
    return StyleTransferConfig(
        output=OutputConfig(
            output=str(out), log_every=1, plot_losses=False,
            log_loss=str(out / "l.csv"), **output,
        ),
        optimization=OptimizationConfig(
            steps=steps, style_layers=[0, 5], content_layers=[2],
            init_method="content", allow_random_weights=True,
            coarse_steps=0, tile_rows=tile_rows,
        ),
        video=VideoConfig(create_video=False, final_only=True),
        hardware=HardwareConfig(device="cpu"),
    )


def _curve(path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    return np.array(rows[1:], dtype=np.float64)[:, -1]


def test_banded_lbfgs_run_matches_whole(tmp_path, images) -> None:
    """The shipped L-BFGS at ``tile_rows=16`` against the whole-image
    run, within the whole run's own sensitivity to its content."""
    paths = InputPaths(str(images["content"]), str(images["style"]))
    curves = {}
    for name, rows in (("whole", 0), ("banded", 16)):
        out = tmp_path / name
        main.style_transfer(paths, _run_config(out, rows))
        curves[name] = _curve(out / "l.csv")
    content = np.asarray(Image.open(images["content"]), dtype=np.float32)
    nudged = content / 255.0 * (
        1 + 1e-7 * np.random.default_rng(9).standard_normal(content.shape)
    )
    out = tmp_path / "nudged"
    out.mkdir()
    main.run_style_transfer(
        nudged[None].astype(np.float32),
        np.asarray(Image.open(images["style"]), np.float32)[None] / 255.0,
        _run_config(out, 0),
    )
    nudged_curve = _curve(out / "l.csv")
    control = float(np.max(np.abs(nudged_curve - curves["whole"])
                           / np.abs(curves["whole"])))
    err = float(np.max(np.abs(curves["banded"] - curves["whole"])
                       / np.abs(curves["whole"])))
    assert err <= max(control, CURVE_FLOOR), (err, control)
    assert np.all(np.isfinite(curves["banded"]))


def test_banded_resume_is_bit_equal(tmp_path, images) -> None:
    paths = InputPaths(str(images["content"]), str(images["style"]))
    whole = tmp_path / "whole"
    main.style_transfer(paths, _run_config(whole, 16, checkpoint_every=3))
    part = tmp_path / "part"
    main.style_transfer(paths, _run_config(part, 16, steps=3,
                                           checkpoint_every=3))
    main.style_transfer(paths, _run_config(
        part, 16, checkpoint_every=3,
        resume_from=str(part / "checkpoint.npz"),
        checkpoint_path=str(part / "end.npz"),
    ))
    with np.load(whole / "checkpoint.npz") as a, np.load(part / "end.npz") as b:
        assert a.files == b.files
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    png = "stylized_content_x_style.png"
    assert np.array_equal(
        np.asarray(Image.open(whole / png)), np.asarray(Image.open(part / png)),
    )
