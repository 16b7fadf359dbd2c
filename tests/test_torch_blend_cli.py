"""The port's CLI for the whole objective and the style blend vs JAX's.

- the same argv gives the same optimization values in both packages
  (the JAX package's ``build_config_from_cli`` over its parser);
- the same ``SystemExit`` messages for the blend and ``--styles``
  combinations, raised before any run; ``--styles`` without
  ``--style-blend`` reaches ``multi_style_transfer`` with the style
  paths the JAX package's CLI hands its own;
- a blended CLI run on the CPU writes the JAX package's file names,
  with the highest-weight style fronting the comparison walls.
"""
from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from style_transfer_visualizer_tpu import cli as jax_cli
from style_transfer_visualizer_tpu.config import build_config_from_cli
from style_transfer_visualizer_tpu_torch import cli

_FIELDS = (
    "steps", "style_w", "content_w", "tv_w", "lap_w", "lap_pool",
    "preserve_color", "lr", "init_method", "seed", "normalize",
    "style_layers", "content_layers", "style_layer_weights", "model",
    "optimizer", "lbfgs_history_size", "lbfgs_history_dtype",
    "lbfgs_direction", "coarse_steps", "pyramid_levels",
    "allow_random_weights",
)
_BASE = ["--content", "c.png", "--style", "s.png"]


def _jax_opt(argv):
    args = jax_cli.build_arg_parser().parse_args(argv)
    return build_config_from_cli(vars(args)).optimization


def _port_opt(argv):
    return cli.config_from_args(cli.build_parser().parse_args(argv)).optimization


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--optimizer", "adam", "--lr", "0.05", "--tv-w", "0.5"],
        ["--lap-w", "100", "--lap-pool", "2", "--preserve-color", "match"],
        ["--preserve-color", "luminance", "--coarse-steps", "7",
         "--pyramid-levels", "4"],
        ["--style-layer-weights", "1,1,0.5,0.25,0.25"],
        ["--model", "vgg16"],
        ["--model", "vgg16", "--style-layers", "0,5", "--content-layers",
         "12", "--style-layer-weights", "2,0"],
        ["--coarse-steps", "0", "--no-normalize", "--seed", "3"],
    ],
)
def test_same_argv_same_config(extra) -> None:
    ours, ref = _port_opt(_BASE + extra), _jax_opt(_BASE + extra)
    for name in _FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize(
    "extra",
    [
        ["--pyramid-levels", "7"],
        ["--style-layer-weights", "1,1"],
        ["--lap-pool", "0"],
        ["--coarse-steps", "-2"],
        ["--tv-w", "-1"],
    ],
)
def test_same_argv_same_rejection(extra) -> None:
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        _jax_opt(_BASE + extra)
    with pytest.raises(SystemExit):
        cli.main(_BASE + extra)


@pytest.mark.parametrize(
    "argv",
    [
        ["--content", "c.png", "--style", "s.png", "--style-blend", "1,1"],
        ["--content", "c.png", "--styles", " , ", "--style-blend", "1"],
        ["--content", "c.png", "--styles", "a.png,b.png",
         "--style-blend", "1"],
        ["--content", "c.png", "--styles", "a.png,b.png",
         "--style-blend", "1,-1"],
        ["--content", "c.png", "--styles", "a.png,b.png",
         "--style-blend", "0,0"],
        ["--content", "c.png", "--styles", "a.png,b.png",
         "--style-blend", "1,x"],
    ],
)
def test_blend_combinations_exit_like_jax(argv) -> None:
    args = jax_cli.build_arg_parser().parse_args(argv)
    with pytest.raises(SystemExit) as ref:
        jax_cli.run_from_args(args)
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    assert str(ours.value.code) == str(ref.value.code)
    assert isinstance(ours.value.code, str)


def test_styles_without_blend_runs_the_batch(monkeypatch) -> None:
    argv = ["--content", "c.png", "--styles", "a.png, b.png,"]
    calls = {}

    def capture(key):
        def run(content_path, style_paths, config, **_kwargs):
            calls[key] = (content_path, list(style_paths))

        return run

    monkeypatch.setattr(cli, "multi_style_transfer", capture("ours"))
    monkeypatch.setattr(
        jax_cli.stv_main, "multi_style_transfer", capture("ref"),
    )
    assert cli.main(argv) == 0
    jax_cli.run_from_args(jax_cli.build_arg_parser().parse_args(argv))
    assert calls["ours"] == calls["ref"] == ("c.png", ["a.png", "b.png"])


@pytest.mark.parametrize(
    "flag", [["--blend-sweep", "3"], ["--style-masks", "m1.png,m2.png"]],
)
def test_sweep_and_regional_flags_are_not_ported(flag) -> None:
    with pytest.raises(SystemExit) as exc:
        cli.main(["--content", "c.png", "--styles", "a.png,b.png", *flag])
    assert exc.value.code == 2


def test_a_style_is_required() -> None:
    with pytest.raises(SystemExit) as exc:
        cli.main(["--content", "c.png"])
    assert exc.value.code == 2


def test_parse_blend_weights_normalizes_like_jax() -> None:
    paths = ["a.png", "b.png", "c.png"]
    ours = cli._parse_blend_weights("1,3,0", paths)  # noqa: SLF001
    assert ours == jax_cli._parse_blend_weights("1,3,0", paths)  # noqa: SLF001
    assert ours == [("a.png", 0.25), ("b.png", 0.75), ("c.png", 0.0)]


def test_blended_cli_run_names_outputs(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(60)
    paths = {}
    for name in ("content", "soft", "bold"):
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(paths[name])
    out = tmp_path / "out"
    assert cli.main([
        "--content", str(paths["content"]),
        "--styles", f"{paths['soft']},{paths['bold']}",
        "--style-blend", "1,3", "--steps", "2", "--device", "cpu",
        "--allow-random-weights", "--style-layers", "0,5",
        "--content-layers", "2", "--init-method", "content",
        "--optimizer", "adam", "--lr", "0.1", "--tv-w", "0.01",
        "--preserve-color", "match", "--final-only", "--no-plot",
        "--compare-inputs", "--compare-result", "--output", str(out),
    ]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "comparison_content_x_bold.png",
        "comparison_content_x_bold_final.png",
        "stylized_content_x_soft+bold.png",
    ]
