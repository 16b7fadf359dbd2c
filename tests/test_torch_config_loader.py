"""The port's TOML loader and CLI-over-TOML merge vs the JAX package's.

- a TOML that sets every field both packages have, and the root
  ``config.toml`` with its ``device`` line set to ``"cpu"``, load to
  equal values on every shared field in both packages; unknown keys and
  tables are ignored by both; numbers coerce as pydantic's lax mode
  does; out-of-range values raise in both;
- each key of the JAX config with no port yet loads at its JAX default
  only, and raises ``NotImplementedError`` at any other value;
  ``steps_per_dispatch`` loads any value >= 0 equal to the JAX
  package's, from the TOML and from ``--steps-per-dispatch`` through
  ``cli.main``, and a negative one raises in both;
  ``device = "tpu"`` raises ``ValueError`` naming ``cuda``;
- a table of argv x TOML cases: the port's ``cli.config_from_args``
  over its ``ConfigLoader`` gives the merged config of the JAX
  package's ``build_config_from_cli`` over its own; only flags the user
  typed override the TOML. The one known difference is the JAX
  parser's: its ``--log-every`` and ``--log-loss`` carry a value even
  when not typed, so they override the TOML there and not here;
- ``--validate-config-only`` returns 0 and runs nothing, exits 2
  without ``--config``; the ``--styles`` help describes the batch.
"""
from __future__ import annotations

from dataclasses import fields

import pytest

from style_transfer_visualizer_tpu import cli as jax_cli
from style_transfer_visualizer_tpu import config as jax_config
from style_transfer_visualizer_tpu_torch import cli
from style_transfer_visualizer_tpu_torch import config as port_config

ROOT_TOML = "config.toml"
SECTIONS = ("output", "optimization", "video", "hardware")

EVERY_FIELD = """
[optimization]
steps = 7
style_w = 2e4
content_w = 2
tv_w = 0.5
lap_w = 10.0
lap_pool = 2
preserve_color = "luminance"
lr = 0.5
init_method = "content"
seed = 3
normalize = false
lbfgs_max_iter = 2
lbfgs_max_eval = 3
style_layers = [0, 5, 10]
content_layers = [12]
style_layer_weights = [1, 0.5, 0.25]
model = "vgg16"
optimizer = "adam"
lbfgs_history_size = 20
lbfgs_history_dtype = "float32"
lbfgs_direction = "two-loop"
coarse_steps = 4
pyramid_levels = 3
allow_random_weights = true
remat = false
tile_rows = -1

[video]
save_every = 5
fps = 12
quality = 7
create_video = false
final_only = true
intro_enabled = false
intro_duration_seconds = 2
metadata_title = "T"
metadata_artist = "A"
final_frame_compare = false
outro_duration_seconds = 1.5
mode = "postprocess"
create_gif = true
gif_include_intro = true
gif_include_outro = true

[hardware]
device = "cpu"
precision = "mixed"
gram_backend = "auto"
conv_backend = "auto"
spatial_shards = 1
steps_per_dispatch = 0

[output]
output = "o"
log_every = 5
log_loss = "l.csv"
plot_losses = false
checkpoint_every = 4
checkpoint_path = "c.npz"
resume_from = "r.npz"
profile_dir = "p"
"""


def _shared(section: str) -> list[str]:
    port_cls = port_config._SECTIONS[section]  # noqa: SLF001
    jax_cls = type(getattr(jax_config.StyleTransferConfig(), section))
    return [
        f.name for f in fields(port_cls) if f.name in jax_cls.model_fields
    ]


def _assert_same(ours, ref) -> None:
    for section in SECTIONS:
        for name in _shared(section):
            mine = getattr(getattr(ours, section), name)
            theirs = getattr(getattr(ref, section), name)
            assert mine == theirs, f"{section}.{name}: {mine} vs {theirs}"
            assert type(mine) is type(theirs), f"{section}.{name}"


def _write(tmp_path, text: str, name: str = "c.toml"):
    path = tmp_path / name
    path.write_text(text)
    return path


def test_every_port_field_is_in_the_jax_config() -> None:
    for section in SECTIONS:
        port_cls = port_config._SECTIONS[section]  # noqa: SLF001
        assert [f.name for f in fields(port_cls)] == _shared(section)


def test_every_shared_field_loads_equal(tmp_path) -> None:
    path = _write(tmp_path, EVERY_FIELD)
    ours = port_config.ConfigLoader.load(path)
    ref = jax_config.ConfigLoader.load(str(path))
    _assert_same(ours, ref)
    assert ours.optimization.steps == 7
    assert ours.output.checkpoint_every == 4
    assert ours.video.intro_duration_seconds == 2.0


def test_root_config_loads_equal(tmp_path) -> None:
    with open(ROOT_TOML, encoding="utf-8") as fh:
        text = fh.read()
    assert 'device = "tpu"' in text
    path = _write(tmp_path, text.replace('device = "tpu"', 'device = "cpu"'))
    _assert_same(
        port_config.ConfigLoader.load(path),
        jax_config.ConfigLoader.load(str(path)),
    )


def test_unknown_keys_and_tables_are_ignored_by_both(tmp_path) -> None:
    path = _write(
        tmp_path,
        "[optimization]\nsteps = 3\nno_such_key = 1\n"
        '[hardware]\ndevice = "cpu"\n[nowhere]\nx = 2\n',
    )
    ours = port_config.ConfigLoader.load(path)
    _assert_same(ours, jax_config.ConfigLoader.load(str(path)))
    assert ours.optimization.steps == 3


@pytest.mark.parametrize(
    "line", ["steps = 10.0", "style_w = 3", "content_w = 1e1"],
)
def test_numbers_coerce_like_pydantic(tmp_path, line) -> None:
    path = _write(
        tmp_path, f'[optimization]\n{line}\n[hardware]\ndevice = "cpu"\n',
    )
    _assert_same(
        port_config.ConfigLoader.load(path),
        jax_config.ConfigLoader.load(str(path)),
    )


@pytest.mark.parametrize(
    "text",
    [
        "[optimization]\nsteps = 0\n",
        "[optimization]\nsteps = 2.5\n",
        '[optimization]\nsteps = "ten"\n',
        "[optimization]\nstyle_layers = 5\n",
        "[optimization]\npyramid_levels = 9\n",
        '[optimization]\nmodel = "vgg11"\n',
        "[video]\nfps = 0\n",
        "[video]\nquality = 11\n",
        "[output]\nlog_every = 0\n",
        "[output]\ncheckpoint_every = -1\n",
        "optimization = 3\n",
    ],
)
def test_bad_values_raise_in_both(tmp_path, text) -> None:
    path = _write(tmp_path, text)
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        jax_config.ConfigLoader.load(str(path))
    with pytest.raises(ValueError):  # noqa: PT011
        port_config.ConfigLoader.load(path)


def test_missing_file_raises(tmp_path) -> None:
    with pytest.raises(FileNotFoundError, match="Config file not found"):
        port_config.ConfigLoader.load(tmp_path / "none.toml")


@pytest.mark.parametrize(
    ("section", "key", "value", "item"),
    [
        ("hardware", "precision", '"highest"', "Precision tiers"),
        ("optimization", "remat", "true", "Memory"),
        ("optimization", "tile_rows", "432", "Memory"),
        ("hardware", "spatial_shards", "2", "Spatial"),
        ("hardware", "conv_backend", '"pallas"', "no backend knob"),
        ("hardware", "gram_backend", '"xla"', "no backend knob"),
    ],
)
def test_unported_keys_load_only_at_their_default(
    tmp_path, section, key, value, item,
) -> None:
    path = _write(tmp_path, f"[{section}]\n{key} = {value}\n")
    jax_loaded = jax_config.ConfigLoader.load(str(path))
    if (section, key) not in port_config._UNPORTED:  # noqa: SLF001
        # Ported since (hardware.precision, the precision tiers;
        # optimization.remat and tile_rows, banded evaluation and
        # remat): the value loads as the JAX loader loads it.
        port = port_config.ConfigLoader.load(path)
        assert getattr(getattr(port, section), key) == getattr(
            getattr(jax_loaded, section), key,
        )
        return
    with pytest.raises(NotImplementedError, match=item):
        port_config.ConfigLoader.load(path)


@pytest.mark.parametrize("value", [0, 1, 4, 60])
def test_steps_per_dispatch_loads_like_jax(tmp_path, value) -> None:
    path = _write(
        tmp_path,
        f'[hardware]\ndevice = "cpu"\nsteps_per_dispatch = {value}\n',
    )
    ours = port_config.ConfigLoader.load(path)
    ref = jax_config.ConfigLoader.load(str(path))
    assert ours.hardware.steps_per_dispatch == value
    _assert_same(ours, ref)


@pytest.mark.parametrize("value", [4, 0])
def test_steps_per_dispatch_flag_through_cli_main(
    tmp_path, monkeypatch, value,
) -> None:
    """``--steps-per-dispatch N`` reaches the run's config through
    ``cli.main`` over a TOML, as the JAX CLI's merge gives it."""
    seen = {}

    def capture(paths, config, **kwargs):
        del paths, kwargs
        seen["config"] = config

    monkeypatch.setattr(cli, "style_transfer", capture)
    path = _write(tmp_path, '[hardware]\nsteps_per_dispatch = 7\n')
    argv = ["--content", "c.png", "--style", "s.png", "--config", str(path),
            "--steps-per-dispatch", str(value)]
    assert cli.main(argv) == 0
    ref = jax_config.build_config_from_cli(
        vars(jax_cli.build_arg_parser().parse_args(argv)),
        base_config=jax_config.ConfigLoader.load(str(path)),
    )
    assert seen["config"].hardware.steps_per_dispatch == value
    assert ref.hardware.steps_per_dispatch == value


@pytest.mark.parametrize("text", [
    "[hardware]\nsteps_per_dispatch = -1\n",
    "[hardware]\nsteps_per_dispatch = 1.5\n",
])
def test_bad_steps_per_dispatch_raises_in_both(tmp_path, text) -> None:
    path = _write(tmp_path, text)
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        jax_config.ConfigLoader.load(str(path))
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        port_config.ConfigLoader.load(path)


def test_tpu_device_is_refused(tmp_path) -> None:
    path = _write(tmp_path, '[hardware]\ndevice = "tpu"\n')
    assert jax_config.ConfigLoader.load(str(path)).hardware.device == "tpu"
    with pytest.raises(ValueError, match="'cuda'"):
        port_config.ConfigLoader.load(path)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--content", "c.png", "--style", "s.png", "--device",
                  "tpu"])
    assert exc.value.code == 2


# --- the CLI over the TOML ------------------------------------------------

_TOML = """
[optimization]
steps = 7
style_layers = [0, 5]
content_layers = [2]
model = "{model}"
coarse_steps = 0
init_method = "content"
[video]
mode = "{mode}"
create_gif = true
intro_duration_seconds = 3.0
[hardware]
device = "cpu"
[output]
output = "from_toml"
checkpoint_every = 5
"""


@pytest.mark.parametrize(
    ("model", "mode", "argv"),
    [
        ("vgg19", "realtime", []),
        ("vgg19", "realtime", ["--steps", "9", "--lr", "0.5"]),
        ("vgg19", "postprocess", []),
        ("vgg19", "realtime", ["--video-mode", "postprocess"]),
        ("vgg19", "realtime", ["--no-gif", "--no-video", "--no-intro"]),
        ("vgg19", "realtime", ["--intro-duration", "-1", "--final-only"]),
        ("vgg19", "realtime", ["--style-layers", "0", "--content-layers",
                               "5", "--no-normalize"]),
        ("vgg16", "realtime", []),
        ("vgg19", "realtime", ["--model", "vgg16"]),
        ("vgg16", "realtime", ["--style-layers", "0,5,10,19,28"]),
        ("vgg19", "realtime", ["--checkpoint-every", "2", "--resume-from",
                               "r.npz", "--checkpoint-path", "c.npz",
                               "--profile-dir", "p"]),
        ("vgg19", "realtime", ["--checkpoint-every", "0", "--output", "o"]),
        ("vgg19", "realtime", ["--device", "cuda", "--allow-random-weights",
                               "--no-plot", "--seed", "4"]),
        ("vgg19", "realtime", ["--optimizer", "adam", "--tv-w", "0.1",
                               "--lap-w", "2", "--preserve-color", "match",
                               "--style-layer-weights", "1,0.5"]),
        ("vgg19", "realtime", ["--no-final-frame-compare", "--fps", "5",
                               "--quality", "3", "--gif-include-intro",
                               "--save-every", "4", "--metadata-title", "t"]),
    ],
)
def test_cli_over_toml_matches_jax(tmp_path, model, mode, argv) -> None:
    path = _write(tmp_path, _TOML.format(model=model, mode=mode))
    full = ["--content", "c.png", "--style", "s.png", "--config", str(path),
            *argv]
    jax_args = jax_cli.build_arg_parser().parse_args(full)
    ref = jax_config.build_config_from_cli(
        vars(jax_args), base_config=jax_config.ConfigLoader.load(str(path)),
    )
    ours = cli.config_from_args(
        cli.build_parser().parse_args(full),
        port_config.ConfigLoader.load(path),
    )
    _assert_same(ours, ref)
    assert ours.video.mode_override == ref.video.mode_override


def test_untyped_log_flags_keep_the_toml_values(tmp_path) -> None:
    """Only typed flags override; the JAX parser's two exceptions."""
    path = _write(
        tmp_path, '[output]\nlog_every = 5\nlog_loss = "l.csv"\n',
    )
    argv = ["--content", "c.png", "--style", "s.png"]
    ours = cli.config_from_args(
        cli.build_parser().parse_args(argv),
        port_config.ConfigLoader.load(path),
    )
    assert (ours.output.log_every, ours.output.log_loss) == (5, "l.csv")
    assert ours.output.plot_losses is False
    jax_args = vars(jax_cli.build_arg_parser().parse_args(argv))
    assert (jax_args["log_every"], jax_args["log_loss"]) == (10, None)
    typed = cli.config_from_args(
        cli.build_parser().parse_args([*argv, "--log-every", "2"]),
        port_config.ConfigLoader.load(path),
    )
    assert typed.output.log_every == 2


def test_the_merge_does_not_touch_the_base(tmp_path) -> None:
    path = _write(tmp_path, "[optimization]\nsteps = 7\n")
    base = port_config.ConfigLoader.load(path)
    merged = cli.config_from_args(
        cli.build_parser().parse_args(["--steps", "3"]), base,
    )
    assert (merged.optimization.steps, base.optimization.steps) == (3, 7)


def test_validate_config_only_runs_nothing(tmp_path, monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise AssertionError((args, kwargs))

    monkeypatch.setattr(cli, "style_transfer", refuse)
    monkeypatch.setattr(cli, "multi_style_transfer", refuse)
    path = _write(tmp_path, "[optimization]\nsteps = 3\n")
    assert cli.main(["--config", str(path), "--validate-config-only"]) == 0
    with pytest.raises(SystemExit) as exc:
        cli.main(["--validate-config-only"])
    assert exc.value.code == 2
    bad = _write(tmp_path, "[hardware]\nspatial_shards = 2\n", "bad.toml")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--config", str(bad), "--validate-config-only"])
    assert exc.value.code == 2


def test_styles_help_describes_the_batch() -> None:
    text = cli.build_parser().format_help()
    assert "not ported" not in text
    styles = next(
        a for a in cli.build_parser()._actions  # noqa: SLF001
        if "--styles" in a.option_strings
    )
    assert "multi-style batch" in styles.help
