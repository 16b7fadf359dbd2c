"""The port's frame sequence and its targets-as-argument step vs JAX's.

On the CPU, with the same seeded weights and numpy inputs:

- ``compute_content_targets``: within 1e-5 relative of the JAX
  package's (float32 convs, sums in another order);
- ``sequence.build_targets_update`` against the port's own
  ``engine.step.build_update_step`` on the same targets: bit-equal
  images, losses and optimizer state for Adam, L-BFGS, and with the TV
  and Laplacian terms (both are one objective, one optimizer);
- ``discover_frames`` (natural order, ``.JPG``), ``_resolve_frame_source``
  (stride and cap, directory and GIF clip): the JAX package's lists;
- ``stylize_sequence`` end to end at 64x64 with Adam: each frame's
  per-step loss curve within 1e-3 relative of the JAX run's and each
  stylized PNG within 2 uint8 levels, each JAX frame started from the
  port's start image of that frame (``tests/torch_pipelines.
  trace_frames`` says why), each port frame from the last one's image;
  plain, with color matching, and with a style blend, luminance color
  and the Laplacian term; frame 0 of a sequence is
  ``main.run_style_transfer`` on that frame, bit for bit (PNG and final
  loss), with the shipped L-BFGS and a random start;
- assembly (GIF, ``--output-video``) and the JAX refusals;
- ``style-sequence-torch`` flag for flag against the JAX package's
  ``style-sequence``, and ``--precision``/``--spatial-shards`` off
  their JAX defaults reaching the run's config.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import style_transfer_visualizer_tpu.sequence as jax_seq
import style_transfer_visualizer_tpu.sequence_cli as jax_seq_cli
from style_transfer_visualizer_tpu import image_io as jax_image_io
from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu_torch import (
    image_io,
    main,
    sequence,
    sequence_cli,
)
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models import features, vgg19
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from tests import goldens_lib
from tests.torch_pipelines import (
    assert_curves,
    assert_pngs_close,
    jax_config,
    png,
    port_config,
    trace_frames,
)

LOSS_RTOL = 1e-5
STYLE, CONTENT = (0, 5), (2,)


def _rng_image(seed: int, shape=(1, 32, 32, 3)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def params_pair():
    return (
        jax_vgg19.init_random_params(jax.random.key(0)),
        vgg19.init_random_params(0, "cpu"),
    )


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return goldens_lib.write_inputs(tmp_path / "in")


# --- compute_content_targets ----------------------------------------------


@pytest.mark.parametrize("layers", [(2,), (2, 7), ()])
def test_compute_content_targets_match_jax(params_pair, layers) -> None:
    params_j, params_t = params_pair
    content = _rng_image(3)
    ref = jax_features.compute_content_targets(
        params_j, jax_image_io.normalize_image(jnp.asarray(content)), layers,
    )
    ours = features.compute_content_targets(
        params_t,
        image_io.host_array_to_device(content, "cpu", normalize=True),
        layers,
    )
    assert sorted(ours) == sorted(ref) == sorted(layers)
    for idx, value in ref.items():
        value = np.asarray(value)
        assert not ours[idx].requires_grad
        np.testing.assert_allclose(
            ours[idx].numpy(), value, rtol=LOSS_RTOL,
            atol=LOSS_RTOL * np.abs(value).max(),
        )


# --- build_targets_update vs build_update_step ----------------------------


@pytest.mark.parametrize(
    "opt",
    [
        {"optimizer": "adam", "lr": 0.1},
        {"optimizer": "lbfgs", "lr": 1.0},
        {"optimizer": "lbfgs", "lr": 1.0, "lbfgs_history_dtype": "float32",
         "lbfgs_direction": "two-loop", "tv_w": 0.5},
        {"optimizer": "adam", "lr": 0.1, "lap_w": 10.0, "lap_pool": 2,
         "style_layer_weights": [1.0, 0.5]},
    ],
    ids=["adam", "lbfgs", "lbfgs-f32-tv", "adam-lap-weights"],
)
def test_targets_update_is_bit_equal_to_build_update_step(
    params_pair, tmp_path, opt,
) -> None:
    _, params = params_pair
    config = port_config(tmp_path, **opt)
    o = config.optimization
    content = image_io.host_array_to_device(
        _rng_image(4), "cpu", normalize=True,
    )
    style = image_io.host_array_to_device(_rng_image(5), "cpu", normalize=True)
    targets = features.compute_targets(
        params, style, content, STYLE, CONTENT,
    )
    lap_target = lap_response(content, o.lap_pool) if o.lap_w else None
    bundle = build_update_step(
        params, targets, tuple(content.shape),
        optimizer=o.optimizer, lr=o.lr, style_w=o.style_w,
        content_w=o.content_w, tv_w=o.tv_w, lap_w=o.lap_w,
        lap_pool=o.lap_pool, lap_target=lap_target, style_layers=STYLE,
        content_layers=CONTENT, style_weights=o.style_weights_tuple(),
        lbfgs_history_size=o.lbfgs_history_size,
        lbfgs_history_dtype=o.lbfgs_history_dtype,
        lbfgs_direction=o.lbfgs_direction,
    )
    update, update_many, init_state, run_params = (
        sequence.build_targets_update(params, tuple(content.shape), config)
    )
    assert run_params is params
    run_targets = (targets, lap_target) if o.lap_w else targets
    x_a = x_b = content.clone()
    st_a, st_b = bundle.opt_state, init_state()
    for _ in range(3):
        x_a, st_a, aux_a = bundle.update_fn(x_a, st_a)
        x_b, st_b, aux_b = update(x_b, st_b, run_params, run_targets)
        assert torch.equal(x_a, x_b)
        assert torch.equal(aux_a.loss, aux_b.loss)
    for name in vars(st_a):
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    x_c, _, auxes = update_many(content.clone(), init_state(), params,
                                run_targets, 3)
    assert torch.equal(x_c, x_a)
    assert auxes.loss.shape == (3,)
    assert torch.equal(auxes.loss[-1], aux_a.loss)


def test_fresh_state_each_call(params_pair, tmp_path) -> None:
    _, params = params_pair
    config = port_config(tmp_path, optimizer="lbfgs", lr=1.0)
    _, _, init_state, _ = sequence.build_targets_update(
        params, (1, 32, 32, 3), config,
    )
    a, b = init_state(), init_state()
    assert a.s_hist is not b.s_hist
    assert a.s_hist.dtype == torch.bfloat16
    assert a.s_hist.shape == (100, 32 * 32 * 3)


# --- frame discovery -------------------------------------------------------


def _touch_frames(root: Path, names: list[str]) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    for name in names:
        Image.new("RGB", (64, 64), (10, 20, 30)).save(
            root / name, format="PNG",
        )
    return root


@pytest.mark.parametrize(
    "names",
    [
        ["frame10.png", "frame2.png", "frame1.png"],
        ["B.JPG", "a.jpg", "c.Png", "notes.txt", "d.bmp", "e.jpeg"],
        ["f_0001.png", "f_0000.png", "f_0010.png", "f_0002.png"],
    ],
)
def test_discover_frames_matches_jax(tmp_path, names) -> None:
    root = _touch_frames(tmp_path / "f", names)
    ours = sequence.discover_frames(root)
    assert ours == jax_seq.discover_frames(root)
    assert all(p.suffix.lower() != ".txt" for p in ours)


def test_discover_frames_natural_order(tmp_path) -> None:
    root = _touch_frames(tmp_path / "f", ["x10.png", "x9.png", "X1.PNG"])
    assert [p.name for p in sequence.discover_frames(root)] == [
        "X1.PNG", "x9.png", "x10.png",
    ]


@pytest.mark.parametrize("case", ["missing", "empty"])
def test_discover_frames_refuses_like_jax(tmp_path, case) -> None:
    root = tmp_path / "f"
    if case == "empty":
        root.mkdir()
        (root / "readme.txt").write_text("x")
    errors = []
    for fn in (sequence.discover_frames, jax_seq.discover_frames):
        with pytest.raises((FileNotFoundError, ValueError)) as exc:
            fn(root)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize(
    ("stride", "cap"), [(1, None), (2, None), (3, 2), (1, 1), (2, 10)],
)
def test_resolve_frame_source_stride_and_cap(tmp_path, stride, cap) -> None:
    root = _touch_frames(tmp_path / "f", [f"f{i}.png" for i in range(7)])
    kwargs = {"max_frames": cap, "frame_stride": stride}
    ours = sequence._resolve_frame_source(root, tmp_path, **kwargs)  # noqa: SLF001
    ref = jax_seq._resolve_frame_source(root, tmp_path, **kwargs)  # noqa: SLF001
    assert ours == ref
    assert ours[1] is None and ours[2] is None


def test_resolve_frame_source_decodes_a_gif_like_jax(tmp_path) -> None:
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    frames = [Image.new("RGB", (64, 64), c) for c in colors]
    clip = tmp_path / "clip.gif"
    frames[0].save(clip, save_all=True, append_images=frames[1:],
                   duration=50, loop=0)
    outs = []
    for name, module in (("ours", sequence), ("ref", jax_seq)):
        out = tmp_path / name
        out.mkdir()
        found, extracted, fps = module._resolve_frame_source(  # noqa: SLF001
            clip, out, max_frames=2, frame_stride=2,
        )
        assert extracted is not None and extracted.parent == out
        assert fps == pytest.approx(20.0)
        outs.append([png(p) for p in found])
    assert len(outs[0]) == 2
    for a, b in zip(*outs, strict=True):
        np.testing.assert_array_equal(a, b)


def test_resolve_frame_source_refuses_an_empty_result(tmp_path) -> None:
    root = _touch_frames(tmp_path / "f", ["a.png"])
    with pytest.raises(ValueError, match="No frames left"):
        sequence._resolve_frame_source(  # noqa: SLF001
            root, tmp_path, max_frames=0, frame_stride=1,
        )


# --- end to end ------------------------------------------------------------

_E2E = {
    "plain": ({}, False),
    "blend-luminance-lap": (
        {"preserve_color": "luminance", "lap_w": 10.0, "lap_pool": 2,
         "tv_w": 0.1},
        True,
    ),
    "match": ({"preserve_color": "match"}, False),
}


@pytest.mark.parametrize("mode", list(_E2E))
def test_sequence_curves_match_jax(
    tmp_path, inputs, monkeypatch, mode,
) -> None:
    opt, blended = _E2E[mode]
    blend = (
        [(inputs.style1, 0.6), (inputs.style2, 0.4)] if blended else None
    )
    ours_c = trace_frames(monkeypatch, sequence)
    ours = sequence.stylize_sequence(
        inputs.frames_dir, inputs.style1,
        port_config(tmp_path / "ours", **opt), tmp_path / "ours",
        style_blend=blend,
    )
    ref_c = trace_frames(monkeypatch, jax_seq, replay=ours_c)
    ref = jax_seq.stylize_sequence(
        inputs.frames_dir, inputs.style1,
        jax_config(tmp_path / "ref", **opt), tmp_path / "ref",
        style_blend=blend,
    )
    assert [p.name for p in ours.frame_paths] == [
        p.name for p in ref.frame_paths
    ] == ["stylized_f00.png", "stylized_f01.png"]
    assert ours.total_steps == ref.total_steps == 6
    ours_c.assert_carried()
    assert_curves(ours_c, ref_c)
    np.testing.assert_allclose(
        ours.frame_losses, ref.frame_losses, rtol=1e-3,
    )
    assert len(ours.frame_seconds) == 2
    for a, b in zip(ours.frame_paths, ref.frame_paths, strict=True):
        assert_pngs_close(a, b)


def test_frame0_is_the_single_run(tmp_path, inputs) -> None:
    """Frame 0 of a sequence is ``run_style_transfer`` on that frame.

    The shipped L-BFGS from a random start (the same generator draw on
    the same device): the same PNG and the same final loss, bit for
    bit.
    """
    opt = {"optimizer": "lbfgs", "lr": 1.0, "init_method": "random"}
    result = sequence.stylize_sequence(
        inputs.frames_dir, inputs.style1,
        port_config(tmp_path / "seq", **opt), tmp_path / "seq",
    )
    frame0 = sorted(inputs.frames_dir.iterdir())[0]
    config = port_config(tmp_path / "one", **opt)
    config.output.log_every = 1
    image, history = main.run_style_transfer(
        image_io.load_image_to_host_array(frame0),
        image_io.load_image_to_host_array(inputs.style1),
        config,
    )
    single = image_io.pack_uint8_frame(image).numpy()
    np.testing.assert_array_equal(png(result.frame_paths[0]), single)
    assert result.frame_losses[0] == history["total_loss"][-1]
    # A warm-started frame ends below frame 0 at the same budget.
    assert result.frame_losses[1] < result.frame_losses[0]


def test_sequence_assembles_gif_and_output_video(tmp_path, inputs) -> None:
    out = tmp_path / "out"
    result = sequence.stylize_sequence(
        inputs.frames_dir, inputs.style1, port_config(out), out,
        assemble_gif=True, output_video="clip.gif", output_fps=4.0,
    )
    for name in ("stylized_sequence.gif", "clip.gif"):
        with Image.open(out / name) as gif:
            assert gif.n_frames == len(result.frame_paths) == 2
    with Image.open(out / "clip.gif") as gif:
        assert gif.info["duration"] == 250


def test_sequence_refuses_frames_of_another_shape(tmp_path, inputs) -> None:
    Image.new("RGB", (80, 64), (1, 2, 3)).save(inputs.frames_dir / "f02.png")
    with pytest.raises(ValueError, match="all frames must match"):
        sequence.stylize_sequence(
            inputs.frames_dir, inputs.style1, port_config(tmp_path),
            tmp_path,
        )


@pytest.mark.parametrize("suffix", [".avi", ".png"])
def test_assemble_output_video_refuses_like_jax(tmp_path, suffix) -> None:
    msgs = []
    for module, cfg in (
        (sequence, port_config(tmp_path)), (jax_seq, jax_config(tmp_path)),
    ):
        with pytest.raises(ValueError) as exc:  # noqa: PT011
            module.assemble_output_video(
                [], tmp_path / f"out{suffix}", 10.0, cfg,
            )
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_mp4_output_needs_ffmpeg(tmp_path, inputs, monkeypatch) -> None:
    monkeypatch.setenv("PATH", str(tmp_path / "nobin"))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        sequence.stylize_sequence(
            inputs.frames_dir, inputs.style1, port_config(tmp_path),
            tmp_path, output_video="clip.mp4",
        )


def test_sequence_runs_on_cuda_by_default(tmp_path, inputs) -> None:
    config = port_config(tmp_path)
    config.hardware.device = "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence.stylize_sequence(
            inputs.frames_dir, inputs.style1, config, tmp_path,
        )


# --- the CLI ---------------------------------------------------------------


def _flags(parser: argparse.ArgumentParser) -> dict[str, tuple]:
    return {
        opt: (action.dest, action.nargs, tuple(action.choices or ()),
              action.required)
        for action in parser._actions  # noqa: SLF001
        for opt in action.option_strings
    }


def test_sequence_cli_flags_match_jax() -> None:
    ours = _flags(sequence_cli.build_parser())
    ref = _flags(jax_seq_cli.build_parser())
    assert ours == ref
    assert len(ours) == 37  # 35 flags, -h and --help


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--optimizer", "adam", "--lr", "0.05", "--tv-w", "0.5",
         "--steps", "7"],
        ["--lap-w", "10", "--lap-pool", "2", "--preserve-color", "match",
         "--style-layers", "0,5", "--content-layers", "2",
         "--style-layer-weights", "1,0.5"],
        ["--model", "vgg16", "--coarse-steps", "3", "--no-normalize",
         "--seed", "4", "--init-method", "white", "--fps", "12"],
        ["--lbfgs-history-size", "8", "--lbfgs-history-dtype", "float32",
         "--lbfgs-direction", "two-loop", "--allow-random-weights",
         "--device", "cpu", "--output", "o"],
    ],
)
def test_sequence_cli_forwards_like_jax(monkeypatch, extra) -> None:
    argv = ["--frames", "fr", "--style", "s.png", "--gif",
            "--output-video", "v.gif", "--max-frames", "3",
            "--frame-stride", "2", *extra]
    calls = {}

    def capture(key):
        def run(frames, style, cfg, out, **kw):
            calls[key] = (frames, style, cfg, out, kw)
            return jax_seq.SequenceResult(frame_paths=[], total_steps=0)

        return run

    monkeypatch.setattr(sequence_cli, "stylize_sequence", capture("ours"))
    monkeypatch.setattr(jax_seq_cli, "stylize_sequence", capture("ref"))
    monkeypatch.setenv("STV_NO_XLA_CACHE", "1")
    assert sequence_cli.main(argv) == 0
    assert jax_seq_cli.main(argv) == 0
    (f, s, cfg, out, kw), (rf, rs, rcfg, rout, rkw) = (
        calls["ours"], calls["ref"],
    )
    assert (f, s, str(out), kw) == (rf, rs, str(rout), rkw)
    for name in (
        "steps", "style_w", "content_w", "tv_w", "lap_w", "lap_pool", "lr",
        "optimizer", "model", "init_method", "preserve_color", "seed",
        "coarse_steps", "normalize", "style_layers", "content_layers",
        "style_layer_weights", "lbfgs_history_size", "lbfgs_history_dtype",
        "lbfgs_direction", "allow_random_weights",
    ):
        assert getattr(cfg.optimization, name) == getattr(
            rcfg.optimization, name,
        ), name
    assert cfg.video.fps == rcfg.video.fps


@pytest.mark.parametrize(
    "argv",
    [
        ["--styles", "a.png,b.png"],
        ["--style", "s.png", "--styles", "a.png,b.png", "--style-blend",
         "1,1"],
        ["--style-blend", "1,1", "--style", "s.png"],
        [],
        ["--styles", "a.png,b.png", "--style-blend", "1"],
    ],
)
def test_sequence_cli_style_exits_like_jax(argv) -> None:
    argv = ["--frames", "fr", *argv]
    codes = []
    for module in (sequence_cli, jax_seq_cli):
        with pytest.raises(SystemExit) as exc:
            module.main(argv)
        codes.append(str(exc.value.code))
    assert codes[0] == codes[1]


@pytest.mark.parametrize(
    ("flag", "item"),
    [
        (["--spatial-shards", "2"], "Spatial and dp×sp"),
        (["--precision", "high"], "Precision tiers"),
    ],
)
def test_sequence_cli_refuses_unported_values(
    capsys, monkeypatch, flag, item,
) -> None:
    argv = ["--frames", "fr", "--style", "s.png", *flag]
    if flag[0] in ("--precision", "--spatial-shards"):
        # Ported since (the precision tiers; row-sharded evaluation):
        # the value reaches the config the run gets.
        seen = {}
        monkeypatch.setattr(
            sequence_cli, "stylize_sequence",
            lambda _f, _s, config, *a, **k: seen.setdefault(
                "r", (config, sequence.SequenceResult([], 0)),
            )[1],
        )
        assert sequence_cli.main(argv) == 0
        key = flag[0].removeprefix("--").replace("-", "_")
        assert str(getattr(seen["r"][0].hardware, key)) == flag[1]
        return
    with pytest.raises(SystemExit) as exc:
        sequence_cli.main(argv)
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


def test_sequence_cli_takes_the_jax_defaults(monkeypatch) -> None:
    seen = {}
    monkeypatch.setattr(
        sequence_cli, "stylize_sequence",
        lambda *a, **k: seen.setdefault("r", sequence.SequenceResult([], 0)),
    )
    assert sequence_cli.main([
        "--frames", "fr", "--style", "s.png", "--spatial-shards", "1",
        "--precision", "mixed",
    ]) == 0
    assert "r" in seen


def test_sequence_cli_end_to_end_on_the_cpu(tmp_path, inputs) -> None:
    out = tmp_path / "out"
    assert sequence_cli.main([
        "--frames", str(inputs.frames_dir), "--style", str(inputs.style1),
        "--steps", "2", "--optimizer", "adam", "--lr", "0.1",
        "--style-layers", "0,5", "--content-layers", "2",
        "--init-method", "content", "--device", "cpu",
        "--allow-random-weights", "--output", str(out), "--gif",
    ]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "stylized_f00.png", "stylized_f01.png", "stylized_sequence.gif",
    ]
