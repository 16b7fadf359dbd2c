"""Row-sharded runs of the port end to end, on the CPU.

The sharded runs go through their entry points (``main.style_transfer``,
``blend_sweep.stylize_blend_sweep``, ``sequence.stylize_sequence``)
called with each rank's mesh, all in one spawn of 2 gloo ranks
(``tests/torch_spatial_workers.run_battery``); the whole-image runs
they are held to run in this process. Gates:

- the shipped L-BFGS sharded against the whole run within the control:
  the whole run against itself from content perturbed by 1e-7
  relative, the floor 1e-3 (ROADMAP.md section 3 item 1);
- a blend with the TV and Laplacian terms and the warm start, Adam at
  lr 0.05, within 1e-3 a step of the whole run;
- a sharded run resumed from step 3 bit-equal to the uninterrupted
  sharded run (checkpoint and PNG);
- the sweep's and the sequence's frame 0 sharded against their whole
  frame 0, within the control;
- the refusals: ``tile_rows``, regional masks (the JAX package's
  messages) and too few cards; the batch with ``spatial_shards``, which
  now runs over a style x space mesh;
- ``--spatial-shards`` on both CLIs and ``hardware.spatial_shards`` in
  the TOML, which start the ranks themselves.
"""
from __future__ import annotations

import csv
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu import config as jax_config
from style_transfer_visualizer_tpu import main as jax_main
from style_transfer_visualizer_tpu import regional as jax_regional
from style_transfer_visualizer_tpu.type_defs import (
    InputPaths as JaxInputPaths,
)
from style_transfer_visualizer_tpu_torch import (
    blend_sweep,
    cli,
    main,
    regional,
    sequence,
    sequence_cli,
)
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.parallel import mesh
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from tests import torch_spatial_workers

CURVE_FLOOR = 1e-3
ADAM_RTOL = 1e-3
SHARDS = 2
STEPS = 6
#: Seconds the battery's ranks may take in all (a loaded host runs them
#: several times slower than an idle one); one collective's bound.
DEADLINE = 600.0
TIMEOUT = 300.0
_OPT = {
    "style_layers": [0, 5, 10], "content_layers": [7],
    "init_method": "content", "allow_random_weights": True,
    "coarse_steps": 0,
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_inputs")
    rng = np.random.default_rng(40)
    paths = {}
    for name in ("content", "style", "style2", "frames/f00", "frames/f01"):
        paths[name] = root / f"{name}.png"
        paths[name].parent.mkdir(exist_ok=True)
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(paths[name])
    paths["frames"] = root / "frames"
    return paths


def _config(out, shards: int, steps: int = STEPS, output=None, **opt):
    return StyleTransferConfig(
        output=OutputConfig(
            output=str(out), log_every=1, plot_losses=False,
            log_loss=str(out / "l.csv"), **(output or {}),
        ),
        optimization=OptimizationConfig(**{**_OPT, "steps": steps, **opt}),
        video=VideoConfig(create_video=False, final_only=True),
        hardware=HardwareConfig(device="cpu", spatial_shards=shards),
    )


_BLEND = {
    "optimizer": "adam", "lr": 0.05, "tv_w": 0.01, "lap_w": 1.0,
    "coarse_steps": 2, "preserve_color": "luminance",
}


def _jobs(root, inputs) -> dict:
    paths = InputPaths(str(inputs["content"]), str(inputs["style"]))
    blend = [(str(inputs["style"]), 0.7), (str(inputs["style2"]), 0.3)]
    part = root / "part"
    return {
        "lbfgs": ("single", (paths, _config(root / "lbfgs", SHARDS)), {}),
        "blend": (
            "single", (paths, _config(root / "blend", SHARDS, **_BLEND)),
            {"style_blend": blend},
        ),
        "uninterrupted": ("single", (paths, _config(
            root / "whole_run", SHARDS, output={"checkpoint_every": 3},
        )), {}),
        "part": ("single", (paths, _config(
            part, SHARDS, steps=3, output={"checkpoint_every": 3},
        )), {}),
        "resumed": ("single", (paths, _config(part, SHARDS, output={
            "checkpoint_every": 3,
            "resume_from": str(part / "checkpoint.npz"),
            "checkpoint_path": str(part / "end.npz"),
        })), {}),
        "sweep": ("sweep", (
            str(inputs["content"]), [str(inputs["style"]),
                                     str(inputs["style2"])],
            _config(root / "sweep", SHARDS),
        ), {"n_frames": 2, "sweep_steps": 2}),
        "sequence": ("sequence", (
            str(inputs["frames"]), str(inputs["style"]),
            _config(root / "seq", SHARDS), str(root / "seq"),
        ), {}),
    }


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, inputs):
    """``(root, rank 0's results)``: every sharded job in one spawn."""
    root = tmp_path_factory.mktemp("sharded")
    out = mesh.launch(
        torch_spatial_workers.run_battery, (_jobs(root, inputs),), SHARDS,
        "cpu", timeout=TIMEOUT, deadline=DEADLINE,
    )
    return root, out


def _curve(path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    return np.array(rows[1:], dtype=np.float64)[:, -1]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _host(path) -> np.ndarray:
    return np.asarray(Image.open(path), np.float32)[None] / 255.0


@pytest.fixture(scope="module")
def whole(tmp_path_factory, inputs):
    """The whole-image L-BFGS curve and the control's bound."""
    root = tmp_path_factory.mktemp("whole")
    paths = InputPaths(str(inputs["content"]), str(inputs["style"]))
    main.style_transfer(paths, _config(root / "whole", 1))
    curve = _curve(root / "whole" / "l.csv")
    content = _host(inputs["content"])
    nudged = content * (
        1 + 1e-7 * np.random.default_rng(9).standard_normal(content.shape)
    )
    (root / "nudged").mkdir()
    main.run_style_transfer(
        nudged.astype(np.float32), _host(inputs["style"]),
        _config(root / "nudged", 1),
    )
    control = _rel(_curve(root / "nudged" / "l.csv"), curve)
    return root, curve, max(control, CURVE_FLOOR)


def test_sharded_lbfgs_run_within_the_control(sharded, whole) -> None:
    root, _ = sharded
    _, curve, bound = whole
    got = _curve(root / "lbfgs" / "l.csv")
    assert got.shape == curve.shape
    assert np.all(np.isfinite(got))
    assert _rel(got, curve) <= bound


def test_sharded_blend_with_every_term_matches_whole(
    tmp_path, sharded, inputs,
) -> None:
    """Two blended styles, TV and Laplacian terms, the warm start
    (rank 0's, handed to every rank) and luminance: Adam a step."""
    root, out = sharded
    paths = InputPaths(str(inputs["content"]), str(inputs["style"]))
    blend = [(str(inputs["style"]), 0.7), (str(inputs["style2"]), 0.3)]
    image = main.style_transfer(
        paths, _config(tmp_path, 1, **_BLEND), style_blend=blend,
    )
    got = _curve(root / "blend" / "l.csv")
    assert _rel(got, _curve(tmp_path / "l.csv")) <= ADAM_RTOL
    assert out["blend"]["image"].shape == tuple(image.shape)
    assert np.abs(out["blend"]["image"] - image.numpy()).max() <= 1e-3
    png = "stylized_content_x_style+style2.png"
    assert (root / "blend" / png).is_file()


def test_sharded_resume_is_bit_equal(sharded) -> None:
    root, out = sharded
    with (
        np.load(root / "whole_run" / "checkpoint.npz") as a,
        np.load(root / "part" / "end.npz") as b,
    ):
        assert a.files == b.files
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    assert np.array_equal(
        out["uninterrupted"]["image"], out["resumed"]["image"],
    )
    png = "stylized_content_x_style.png"
    assert np.array_equal(
        np.asarray(Image.open(root / "whole_run" / png)),
        np.asarray(Image.open(root / "part" / png)),
    )


def test_sweep_frame0_sharded_within_the_control(
    tmp_path, sharded, inputs, whole,
) -> None:
    root, out = sharded
    ref = blend_sweep.stylize_blend_sweep(
        str(inputs["content"]),
        [str(inputs["style"]), str(inputs["style2"])],
        _config(tmp_path, 1), n_frames=2, sweep_steps=2,
    )
    losses = out["sweep"]["losses"]
    assert losses.shape == (2,)
    assert np.all(np.isfinite(losses))
    assert _rel(losses[0], ref.frame_losses[0]) <= whole[2]
    assert sorted(p.name for p in (root / "sweep").glob("sweep_*.png")) == [
        "sweep_0000.png", "sweep_0001.png",
    ]


def test_sequence_frame0_sharded_within_the_control(
    tmp_path, sharded, inputs, whole,
) -> None:
    root, out = sharded
    ref = sequence.stylize_sequence(
        str(inputs["frames"]), str(inputs["style"]), _config(tmp_path, 1),
        str(tmp_path),
    )
    losses = out["sequence"]["losses"]
    assert losses.shape == (2,)
    assert np.all(np.isfinite(losses))
    assert _rel(losses[0], ref.frame_losses[0]) <= whole[2]
    assert sorted(p.name for p in (root / "seq").glob("stylized_*.png")) == [
        "stylized_f00.png", "stylized_f01.png",
    ]


# --- refusals -------------------------------------------------------------


def _jax_cfg(out, **hardware):
    cfg = jax_config.StyleTransferConfig()
    cfg.output.output = str(out)
    cfg.optimization.allow_random_weights = True
    cfg.optimization.steps = 1
    cfg.video.final_only = True
    cfg.hardware.device = "cpu"
    for key, value in hardware.items():
        setattr(cfg.hardware, key, value)
    return cfg


def _error(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as exc:  # noqa: PT011 - message compared
        fn(*args, **kwargs)
    return str(exc.value)


def test_tile_rows_is_refused_with_the_jax_message(tmp_path, inputs) -> None:
    jax_cfg = _jax_cfg(tmp_path / "ref", spatial_shards=2)
    jax_cfg.optimization.tile_rows = 16
    ref = _error(
        jax_main.style_transfer,
        JaxInputPaths(str(inputs["content"]), str(inputs["style"])), jax_cfg,
    )
    paths = InputPaths(str(inputs["content"]), str(inputs["style"]))
    cfg = _config(tmp_path / "ours", SHARDS, tile_rows=16)
    assert _error(main.style_transfer, paths, cfg) == ref
    assert _error(
        sequence.stylize_sequence, str(inputs["frames"]),
        str(inputs["style"]), cfg, str(tmp_path / "seq"),
    ) == ref
    assert _error(
        blend_sweep.stylize_blend_sweep, str(inputs["content"]),
        [str(inputs["style"]), str(inputs["style2"])], cfg, n_frames=2,
    ) == ref


def test_regional_is_refused_with_the_jax_message(tmp_path, inputs) -> None:
    styles = [str(inputs["style"]), str(inputs["style2"])]
    masks = [str(inputs["style"]), str(inputs["style2"])]
    ref = _error(
        jax_regional.stylize_regional, str(inputs["content"]), styles, masks,
        _jax_cfg(tmp_path, spatial_shards=2),
    )
    ours = _error(
        regional.stylize_regional, str(inputs["content"]), styles, masks,
        _config(tmp_path, SHARDS),
    )
    assert ours == ref
    with pytest.raises(SystemExit, match="not supported with --style-masks"):
        cli.main([
            "--content", str(inputs["content"]), "--styles",
            ",".join(styles), "--style-masks", ",".join(masks),
            "--spatial-shards", "2", "--device", "cpu",
        ])


def test_the_batch_waits_for_its_queue_item(tmp_path, inputs) -> None:
    """The batch with ``spatial_shards`` runs over a style x space mesh:
    the entry point starts its 2 x 2 ranks and world rank 0 writes
    both PNGs; ``prepare_multi_style``, whose step is bound to a rank's
    process group, takes each rank's mesh and points there without
    one (its ranks run in ``tests/test_torch_batch_mesh.py``)."""
    styles = [str(inputs["style"]), str(inputs["style2"])]
    saved = main.multi_style_transfer(
        str(inputs["content"]), styles, _config(tmp_path, SHARDS, steps=2),
    )
    assert [p.name for p in saved] == [
        "stylized_content_x_style.png", "stylized_content_x_style2.png",
    ]
    for path in saved:
        assert path.is_file()
    with pytest.raises(ValueError, match="pass each rank's mesh"):
        main.prepare_multi_style(
            _host(inputs["content"]), [_host(p) for p in styles],
            _config(tmp_path, SHARDS),
        )


def test_too_few_cards_are_refused(tmp_path, inputs, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = _config(tmp_path, SHARDS)
    cfg.hardware.device = "cuda"
    paths = InputPaths(str(inputs["content"]), str(inputs["style"]))
    assert _error(main.style_transfer, paths, cfg) == (
        "--spatial-shards 2 needs 2 cuda devices; 1 attached."
    )


def test_prepare_without_a_mesh_is_refused(inputs) -> None:
    with pytest.raises(ValueError, match="one process per shard"):
        main.prepare_model_and_input(
            _host(inputs["content"]), _host(inputs["style"]),
            _config(inputs["content"].parent, SHARDS),
        )


# --- the CLIs and the TOML start the ranks ------------------------------


def test_cli_flag_and_toml_key_run_sharded(tmp_path, inputs) -> None:
    toml = tmp_path / "c.toml"
    toml.write_text('[hardware]\ndevice = "cpu"\nspatial_shards = 2\n')
    records: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger.addHandler(handler)
    try:
        assert cli.main([
            "--config", str(toml), "--content", str(inputs["content"]),
            "--style", str(inputs["style"]), "--steps", "2",
            "--style-layers", "0,5", "--content-layers", "2",
            "--final-only", "--allow-random-weights",
            "--output", str(tmp_path / "toml"),
        ]) == 0
        assert cli.main([
            "--content", str(inputs["content"]), "--style",
            str(inputs["style"]), "--steps", "2", "--style-layers", "0,5",
            "--content-layers", "2", "--final-only", "--device", "cpu",
            "--spatial-shards", "2", "--allow-random-weights",
            "--output", str(tmp_path / "flag"),
        ]) == 0
    finally:
        logger.removeHandler(handler)
    assert records.count("Spatial Shards: 2") == 2
    for out in ("toml", "flag"):
        assert (tmp_path / out / "stylized_content_x_style.png").is_file()


def test_sequence_cli_runs_sharded(tmp_path, inputs) -> None:
    assert sequence_cli.main([
        "--frames", str(inputs["frames"]), "--style", str(inputs["style"]),
        "--steps", "2", "--style-layers", "0,5", "--content-layers", "2",
        "--init-method", "content", "--device", "cpu",
        "--spatial-shards", "2", "--allow-random-weights",
        "--output", str(tmp_path),
    ]) == 0
    assert sorted(p.name for p in tmp_path.glob("stylized_*.png")) == [
        "stylized_f00.png", "stylized_f01.png",
    ]
