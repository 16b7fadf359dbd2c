"""The port's step dispatch against the JAX package's, on the CPU.

``hardware.steps_per_dispatch`` and the chunked dispatch it controls:

- the chunk sizes: the runner's ``_resolve_chunk_size`` and the batch's
  ``main.resolve_batch_chunk`` equal the JAX package's
  ``OptimizationRunner._resolve_chunk_size`` and
  ``main._resolve_batch_chunk`` over a table of (``log_every``,
  ``save_every``, a sink, ``checkpoint_every``, ``steps_per_dispatch``,
  per-step callbacks);
- runs at ``steps_per_dispatch`` 0, 1 and 3 (64x64 PNGs of seeded
  noise, seeded weights, taps [0, 5]/[2], content init; Adam 6 steps,
  the shipped L-BFGS 3, ROADMAP §3 item 1): in the port each is bit-equal
  to the others, and each per-step curve is within 1e-3 relative of the
  JAX run with the same value (the curve gate of the JAX package's
  ``ops/precision.py``); the port's dispatches are the chunks worked
  out;
- the batch at S = 2, chunked by its checkpoint cadence: per-style CSV
  rows (read off the chunks' interior steps) and checkpoints at the
  same steps as JAX's, the rows within 1e-3 relative;
- a run resumed off the chunk grid runs single steps until it is back
  on, and writes the same CSV rows, bit for bit, as the whole run;
- ``engine.step.GraphedChunk`` on CPU tensors is the plain loop of the
  eager step (bit-equal), raises on any device but CPU and CUDA;
  ``refill`` and the in-place state reset give what fresh ones give.

The ``cuda``-marked tests at the end run on the card only (each skips
without one): a graphed run bit-equal to the eager loop, launches
counted by the kernels on the device through replays, the arrival counters all 0 after 100
replays, a changed target copied in without a new capture, and a
capture that fails raising instead of running eagerly. On the card's
machine (no JAX there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_dispatch.py -k cuda
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu_torch import main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.engine import runner, step
from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    AdamState,
    LbfgsState,
    StepAux,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths

CURVE_RTOL = 1e-3


class _Jax:
    """The JAX package's modules, imported at first use: the card's
    machine has no JAX, and runs only this file's ``cuda`` tests."""

    def __getattr__(self, name):
        import style_transfer_visualizer_tpu.main as jax_main  # noqa: PLC0415
        from style_transfer_visualizer_tpu import (  # noqa: PLC0415
            config,
            type_defs,
        )
        from style_transfer_visualizer_tpu.engine import (  # noqa: PLC0415
            runner as jax_runner,
        )
        from style_transfer_visualizer_tpu.runtime import (  # noqa: PLC0415
            checkpoint,
        )

        return {
            "main": jax_main, "runner": jax_runner, "checkpoint": checkpoint,
            "Config": config.StyleTransferConfig,
            "InputPaths": type_defs.InputPaths,
        }[name]


jax = _Jax()
_OPT = {
    "style_layers": [0, 5], "content_layers": [2], "init_method": "content",
    "seed": 0, "allow_random_weights": True,
}


class _Bar:
    def update(self, n=1):
        del n

    def set_postfix(self, *args, **kwargs):
        del args, kwargs

    def close(self):
        pass


class _Sink:
    def __init__(self):
        self.frames = []

    def append_data(self, frame):
        self.frames.append(frame)

    def close(self):
        pass


@pytest.fixture
def images(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(41)
    paths = {}
    for name in ("content", "sa", "sb"):
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


# --- the chunk sizes ---------------------------------------------------------

# (log_every, save_every, sink, checkpoint_every, steps_per_dispatch,
#  callbacks)
_TABLE = [
    (10, 20, False, 0, 0, False),
    (10, 20, False, 0, 1, False),
    (10, 20, False, 0, 4, False),
    (10, 20, False, 0, 60, False),
    (10, 20, True, 0, 0, False),
    (10, 6, True, 0, 0, False),
    (10, 6, True, 0, 4, False),
    (10, 6, True, 9, 0, False),
    (10, 60, True, 0, 0, False),
    (10, 60, True, 120, 0, False),
    (7, 20, False, 0, 0, False),
    (1, 20, False, 0, 3, False),
    (12, 8, True, 16, 0, False),
    (12, 8, True, 16, 2, False),
    (10, 20, False, 5, 3, False),
    (10, 20, False, 100, 0, False),
    (10, 20, True, 0, 0, True),
    (10, 20, False, 4, 2, True),
]


def _configs(log_every, save_every, sink, checkpoint_every, per_dispatch,
             csv_path):
    output = {
        "log_every": log_every, "checkpoint_every": checkpoint_every,
        "log_loss": csv_path,
    }
    video = {"save_every": save_every, "create_gif": sink,
             "create_video": False}
    ours = StyleTransferConfig(
        output=OutputConfig(**output),
        optimization=OptimizationConfig(steps=200),
        video=VideoConfig(**video),
        hardware=HardwareConfig(
            device="cpu", steps_per_dispatch=per_dispatch,
        ),
    )
    ref = jax.Config.model_validate({
        "output": output, "optimization": {"steps": 200}, "video": video,
        "hardware": {"device": "cpu", "steps_per_dispatch": per_dispatch},
    })
    return ours, ref


@pytest.mark.parametrize(
    ("log_every", "save_every", "sink", "checkpoint_every", "per_dispatch",
     "callbacks"),
    _TABLE,
)
def test_chunk_sizes_equal_jax(
    tmp_path, log_every, save_every, sink, checkpoint_every, per_dispatch,
    callbacks,
) -> None:
    ours_cfg, ref_cfg = _configs(
        log_every, save_every, sink, checkpoint_every, per_dispatch,
        str(tmp_path / "l.csv"),
    )

    def nothing(*args):
        del args

    got = {}
    for key, mod, cfg in (
        ("ours", runner, ours_cfg), ("ref", jax.runner, ref_cfg),
    ):
        run = mod.OptimizationRunner(
            nothing, None, torch.zeros((1, 2, 2, 3)), cfg,
            progress_bar=_Bar(),
            callbacks=mod.OptimizationCallbacks(
                on_step_end=nothing if callbacks else None,
            ),
            gif_collector=_Sink() if sink else None,
            chunked_update_fn=nothing,
        )
        got[key] = run._resolve_chunk_size()  # noqa: SLF001
        if run.loss_logger is not None:
            run.loss_logger.close()
    assert got["ours"] == got["ref"]

    class Bundle:
        chunked_update_fn = nothing

    assert main.resolve_batch_chunk(Bundle(), ours_cfg) == (
        jax.main._resolve_batch_chunk(Bundle(), ref_cfg)  # noqa: SLF001
    )


def test_no_chunk_function_means_single_steps() -> None:
    cfg, ref = _configs(10, 20, False, 0, 5, None)

    class Bundle:
        chunked_update_fn = None

    assert main.resolve_batch_chunk(Bundle(), cfg) == 1
    assert jax.main._resolve_batch_chunk(Bundle(), ref) == 1  # noqa: SLF001
    run = runner.OptimizationRunner(
        None, None, torch.zeros((1, 2, 2, 3)), cfg, progress_bar=_Bar(),
    )
    assert run._resolve_chunk_size() == 1  # noqa: SLF001


# --- runs at steps_per_dispatch 0, 1 and 3 ----------------------------------


def _dispatches(monkeypatch) -> list[int]:
    """The ``k`` of every dispatch through a ``GraphedChunk``."""
    seen: list[int] = []
    real = step.GraphedChunk.__call__

    def spy(self, image, state, *rest):
        seen.append(rest[-1])
        return real(self, image, state, *rest)

    monkeypatch.setattr(step.GraphedChunk, "__call__", spy)
    return seen


def _single_run(tmp_path, images, monkeypatch, pkg, optimizer, steps,
                per_dispatch):
    """(history, final PNG) of one run; the cadence is a checkpoint
    every ``steps``, so 0 gives one chunk of ``steps``."""
    out = tmp_path / f"{pkg}_{optimizer}_{per_dispatch}"
    opt = {**_OPT, "steps": steps, "optimizer": optimizer}
    if optimizer == "adam":
        opt["lr"] = 0.1
    output = {"output": str(out), "checkpoint_every": steps,
              "plot_losses": False}
    results = []
    if pkg == "ours":
        config = StyleTransferConfig(
            output=OutputConfig(**output),
            optimization=OptimizationConfig(**opt),
            video=VideoConfig(final_only=True, create_video=False),
            hardware=HardwareConfig(
                device="cpu", steps_per_dispatch=per_dispatch,
            ),
        )
        mod, paths = main, InputPaths
    else:
        config = jax.Config.model_validate({
            "output": output, "optimization": opt,
            "video": {"final_only": True, "create_video": False},
            "hardware": {"device": "cpu", "precision": "highest",
                         "steps_per_dispatch": per_dispatch},
        })
        mod, paths = jax.main, jax.InputPaths
    real = mod.run_with_artifacts

    def spy(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(mod, "run_with_artifacts", spy)
    mod.style_transfer(
        paths(str(images["content"]), str(images["sa"])), config,
    )
    monkeypatch.setattr(mod, "run_with_artifacts", real)
    (result,) = results
    history = np.array([
        result.loss_history[k]
        for k in ("style_loss", "content_loss", "total_loss")
    ], dtype=np.float64)
    png = np.asarray(Image.open(out / "stylized_content_x_sa.png"))
    return history, png


@pytest.mark.parametrize(
    ("optimizer", "steps", "chunks"),
    [
        ("adam", 6, {0: [6], 1: [1] * 6, 3: [3, 3]}),
        ("lbfgs", 3, {0: [3], 1: [1] * 3, 3: [3]}),
    ],
)
def test_dispatch_values_agree(
    tmp_path, images, monkeypatch, optimizer, steps, chunks,
) -> None:
    runs = {}
    for per_dispatch, want in chunks.items():
        seen = _dispatches(monkeypatch)
        runs[per_dispatch] = _single_run(
            tmp_path, images, monkeypatch, "ours", optimizer, steps,
            per_dispatch,
        )
        assert seen == want, per_dispatch
        monkeypatch.undo()
        ref_history, _ = _single_run(
            tmp_path, images, monkeypatch, "ref", optimizer, steps,
            per_dispatch,
        )
        history = runs[per_dispatch][0]
        assert history.shape == ref_history.shape == (3, steps)
        np.testing.assert_allclose(history, ref_history, rtol=CURVE_RTOL)
    base_history, base_png = runs[0]
    for per_dispatch in (1, 3):
        history, png = runs[per_dispatch]
        np.testing.assert_array_equal(history, base_history)
        np.testing.assert_array_equal(png, base_png)


# --- the batch, chunked -----------------------------------------------------


def _rows(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["step", "style_loss", "content_loss", "total_loss"]
    return np.array(rows[1:], dtype=np.float64)


def test_batch_chunks_log_and_checkpoint_like_jax(
    tmp_path, images, monkeypatch,
) -> None:
    """6 Adam steps, a checkpoint every 3 (so chunks of 3), a CSV row
    every 2 steps: rows at 2, 4, 6 come off the chunks' interiors."""
    styles = [str(images["sa"]), str(images["sb"])]
    saved = {"ours": [], "ref": []}
    real_ours, real_ref = main.save_checkpoint, jax.checkpoint.save_checkpoint

    def spy_ours(path, step_idx, image, state):
        saved["ours"].append(step_idx)
        return real_ours(path, step_idx, image, state)

    def spy_ref(path, step_idx, image, state, *args, **kwargs):
        saved["ref"].append(step_idx)
        return real_ref(path, step_idx, image, state, *args, **kwargs)

    monkeypatch.setattr(main, "save_checkpoint", spy_ours)
    monkeypatch.setattr(jax.checkpoint, "save_checkpoint", spy_ref)
    seen = _dispatches(monkeypatch)
    opt = {**_OPT, "steps": 6, "optimizer": "adam", "lr": 0.1}
    output = {"log_every": 2, "checkpoint_every": 3}
    main.multi_style_transfer(
        str(images["content"]), styles, StyleTransferConfig(
            output=OutputConfig(
                output=str(tmp_path / "ours"),
                log_loss=str(tmp_path / "ours.csv"), **output,
            ),
            optimization=OptimizationConfig(**opt),
            video=VideoConfig(final_only=True, create_video=False),
            hardware=HardwareConfig(device="cpu"),
        ),
    )
    assert seen == [3, 3]
    jax.main.multi_style_transfer(
        str(images["content"]), styles, jax.Config.model_validate({
            "output": {"output": str(tmp_path / "ref"),
                       "log_loss": str(tmp_path / "ref.csv"), **output},
            "optimization": {**opt, "coarse_steps": 0},
            "video": {"final_only": True, "create_video": False},
            "hardware": {"device": "cpu", "precision": "highest"},
        }),
    )
    assert saved["ours"] == saved["ref"] == [3, 6]
    for style in ("sa", "sb"):
        got = _rows(tmp_path / f"ours_{style}.csv")
        want = _rows(tmp_path / f"ref_{style}.csv")
        np.testing.assert_array_equal(got[:, 0], [2, 4, 6])
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)


def test_batch_rows_equal_single_step_dispatch(tmp_path, images) -> None:
    """The chunked batch's rows are the single-step batch's, bit for bit."""
    rows = {}
    for per_dispatch in (0, 1):
        config = StyleTransferConfig(
            output=OutputConfig(
                output=str(tmp_path / str(per_dispatch)), log_every=1,
                log_loss=str(tmp_path / f"{per_dispatch}.csv"),
                checkpoint_every=3,
            ),
            optimization=OptimizationConfig(**{
                **_OPT, "steps": 6, "optimizer": "adam", "lr": 0.1,
            }),
            video=VideoConfig(final_only=True, create_video=False),
            hardware=HardwareConfig(
                device="cpu", steps_per_dispatch=per_dispatch,
            ),
        )
        main.multi_style_transfer(
            str(images["content"]), [str(images["sa"]), str(images["sb"])],
            config,
        )
        rows[per_dispatch] = [
            _rows(tmp_path / f"{per_dispatch}_{s}.csv") for s in ("sa", "sb")
        ]
    for a, b in zip(rows[0], rows[1], strict=True):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 6


# --- a resume off the chunk grid --------------------------------------------


@pytest.mark.parametrize("batch", [False, True])
def test_resume_off_the_grid_writes_the_same_rows(
    tmp_path, images, monkeypatch, batch,
) -> None:
    """Chunks of 3 (``steps_per_dispatch`` 3, a row every 3 steps): a
    run resumed at step 2 runs step 3 alone, then chunks 4-6 and 7-9."""
    def run(name, steps, **out):
        config = StyleTransferConfig(
            output=OutputConfig(
                output=str(tmp_path / name), log_every=3,
                log_loss=str(tmp_path / name / "l.csv"), **out,
            ),
            optimization=OptimizationConfig(**{
                **_OPT, "steps": steps, "optimizer": "adam", "lr": 0.1,
            }),
            video=VideoConfig(final_only=True, create_video=False),
            hardware=HardwareConfig(device="cpu", steps_per_dispatch=3),
        )
        if batch:
            main.multi_style_transfer(
                str(images["content"]),
                [str(images["sa"]), str(images["sb"])], config,
            )
            return [tmp_path / name / f"l_{s}.csv" for s in ("sa", "sb")]
        main.style_transfer(
            InputPaths(str(images["content"]), str(images["sa"])), config,
        )
        return [tmp_path / name / "l.csv"]

    whole = run("whole", 9)
    run("part", 2, checkpoint_every=2)
    seen = _dispatches(monkeypatch)
    resumed = run(
        "part", 9, resume_from=str(tmp_path / "part" / "checkpoint.npz"),
    )
    assert seen == [1, 3, 3]
    for a, b in zip(whole, resumed, strict=True):
        assert a.read_text() == b.read_text()
        np.testing.assert_array_equal(_rows(a)[:, 0], [3, 6, 9])


# --- GraphedChunk, refill and the state reset on the CPU --------------------


def _toy_update(image, state, target):
    state = AdamState(state.mu + image, state.nu, state.count + 1)
    new = image * 0.5 + target
    one = image.sum()
    return new, state, StepAux(one, one * 2, one * 3, state.count.long())


def test_graphed_chunk_on_cpu_is_the_eager_loop() -> None:
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.normal(size=(1, 4, 5, 3)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(1, 4, 5, 3)).astype(np.float32))
    state = AdamState(torch.zeros_like(image), torch.zeros_like(image),
                      torch.zeros((), dtype=torch.int32))
    chunk = step.chunked(_toy_update)
    assert isinstance(chunk, step.GraphedChunk)
    img_c, st_c, aux = chunk(image, state, target, 4)
    img_e, st_e = image, state
    losses = []
    for _ in range(4):
        img_e, st_e, a = _toy_update(img_e, st_e, target)
        losses.append(a.loss)
    assert torch.equal(img_c, img_e)
    assert torch.equal(st_c.mu, st_e.mu)
    assert torch.equal(aux.loss, torch.stack(losses))
    assert aux.loss.shape == aux.n_evals.shape == (4,)
    assert torch.equal(aux.at(2).loss, losses[2])
    assert chunk.capture_seconds == []


def test_recording_keeps_cuda_dispatches_only() -> None:
    image = torch.zeros((1, 4, 5, 3))
    state = AdamState(torch.zeros_like(image), torch.zeros_like(image),
                      torch.zeros((), dtype=torch.int32))
    chunk = step.chunked(_toy_update)
    with step.recording() as outer:
        with step.recording() as inner:
            chunk(image, state, torch.ones_like(image), 2)
        # The CPU's loop is the plain version: nothing is recorded.
        assert inner == []
    assert outer == []
    assert step._recordings == []  # noqa: SLF001
    # Outside a block a dispatch records nothing and makes no event.
    chunk.note(3)
    assert step.GraphedChunk(_toy_update).serial > chunk.serial


def test_graphed_chunk_refuses_other_devices() -> None:
    image = torch.zeros((1, 2, 2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        step.chunked(_toy_update)(image, None, 1)


def test_refill_clones_then_copies_in_place() -> None:
    a = {"g": [torch.ones(3), torch.zeros(2)], "c": (torch.ones(1),)}
    held = step.refill(None, a)
    assert held["g"][0] is not a["g"][0]
    assert torch.equal(held["g"][0], a["g"][0])
    keep = held["g"][1]
    b = {"g": [torch.full((3,), 2.0), torch.full((2,), 5.0)],
         "c": (torch.zeros(1),)}
    assert step.refill(held, b) is held
    assert held["g"][1] is keep
    assert torch.equal(keep, torch.full((2,), 5.0))
    assert torch.equal(a["g"][1], torch.zeros(2))


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_state_reset_in_place_equals_a_fresh_state(optimizer) -> None:
    def loss_fn(params, img, targets):
        del params
        total = ((img - targets) ** 2).sum()
        return total, (total, total)

    shape = (1, 4, 4, 3)
    update, init_state = step.targets_update(
        loss_fn, shape, torch.device("cpu"), optimizer=optimizer, lr=0.5,
        lbfgs_history_size=3,
    )
    target = torch.from_numpy(
        np.random.default_rng(2).normal(size=shape).astype(np.float32),
    )
    state = init_state()
    image = torch.zeros(shape)
    for _ in range(3):
        image, state, _ = update(image, state, None, target)
    kept = state
    reset = init_state(state)
    assert reset is kept
    fresh = init_state()
    assert isinstance(fresh, LbfgsState if optimizer == "lbfgs" else AdamState)
    for name in step._state_fields(fresh):  # noqa: SLF001
        assert torch.equal(getattr(reset, name), getattr(fresh, name)), name


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_bundle(optimizer: str, size: int = 64):
    rng = np.random.default_rng(3)
    content, style = (
        rng.uniform(size=(1, size, size, 3)).astype(np.float32)
        for _ in range(2)
    )
    config = StyleTransferConfig(
        optimization=OptimizationConfig(**{
            **_OPT, "steps": 8, "optimizer": optimizer, "lr": 0.1,
        }),
        hardware=HardwareConfig(device="cuda"),
    )
    return lambda: main.prepare_model_and_input(content, style, config)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_cuda_graphed_steps_equal_eager(cuda, optimizer) -> None:
    from style_transfer_visualizer_tpu_torch.ops import (  # noqa: PLC0415
        conv3x3,
        gram,
    )

    make = _card_bundle(optimizer)
    bundle, image = make()
    conv3x3.launches.reset()
    gram.launches.reset()
    eager = []
    state = bundle.opt_state
    for _ in range(8):
        image, state, aux = bundle.update_fn(image, state)
        eager.append(aux.loss)
    eager_image = image.clone()
    eager_counts = (conv3x3.launches.launched(), gram.launches.launched())
    # With no graph the kernels' own counts and the wrappers' agree.
    assert eager_counts == (conv3x3.launches.count, gram.launches.count)

    bundle, image = make()
    conv3x3.launches.reset()
    gram.launches.reset()
    image, state, a = bundle.chunked_update_fn(image, bundle.opt_state, 1)
    image, state, b = bundle.chunked_update_fn(image, state, 3)
    image, state, c = bundle.chunked_update_fn(image, state, 4)
    graphed = torch.cat([a.loss, b.loss, c.loss])
    torch.cuda.synchronize()
    assert torch.equal(graphed, torch.stack(eager))
    assert torch.equal(image, eager_image)
    assert len(bundle.chunked_update_fn.capture_seconds) == 1
    # Eight steps' launches, counted by the kernels through the replays.
    assert (
        conv3x3.launches.launched(), gram.launches.launched(),
    ) == eager_counts


@pytest.mark.cuda
def test_cuda_launches_counted_through_replays(cuda) -> None:
    from style_transfer_visualizer_tpu_torch.ops import (  # noqa: PLC0415
        conv3x3,
        gram,
    )

    make = _card_bundle("lbfgs")
    bundle, image = make()
    conv3x3.launches.reset()
    gram.launches.reset()
    state = bundle.opt_state
    for _ in range(5):
        image, state, _ = bundle.update_fn(image, state)
    eager = (conv3x3.launches.launched(), gram.launches.launched())
    assert eager == (conv3x3.launches.count, gram.launches.count)
    bundle, image = make()
    conv3x3.launches.reset()
    gram.launches.reset()
    # A warm-up step, a capture (it runs nothing), 4 replays.
    bundle.chunked_update_fn(image, bundle.opt_state, 5)
    assert (conv3x3.launches.launched(), gram.launches.launched()) == eager
    assert eager[0] > 0 and eager[1] > 0
    # The wrappers were called for the warm-up and the capture only.
    per_step = (eager[0] // 5, eager[1] // 5)
    assert (conv3x3.launches.count, gram.launches.count) == (
        2 * per_step[0], 2 * per_step[1],
    )


@pytest.mark.cuda
def test_cuda_arrival_counters_zero_after_replays(cuda) -> None:
    from style_transfer_visualizer_tpu_torch.native import (  # noqa: PLC0415
        build,
    )

    bundle, image = _card_bundle("adam")()
    bundle.chunked_update_fn(image, bundle.opt_state, 101)
    torch.cuda.synchronize()
    counters = build.counter_buffer(cuda)
    assert counters is not None
    assert int(counters.count_nonzero()) == 0


@pytest.mark.cuda
def test_cuda_new_targets_are_copied_without_a_capture(cuda) -> None:
    def update(image, state, target):
        return image * 0.5 + target, state, StepAux(
            image.sum(), image.sum(), image.sum(),
            torch.ones((), dtype=torch.int64, device=image.device),
        )

    state = AdamState(*(torch.zeros(3, device=cuda) for _ in range(2)),
                      torch.zeros((), dtype=torch.int32, device=cuda))
    chunk = step.chunked(update)
    held = step.refill(None, torch.ones(3, device=cuda))
    image, state, _ = chunk(torch.zeros(3, device=cuda), state, held, 2)
    assert torch.equal(image, torch.full((3,), 1.5, device=cuda))
    step.refill(held, torch.full((3,), 2.0, device=cuda))
    image, state, _ = chunk(image, state, held, 1)
    assert torch.equal(image, torch.full((3,), 2.75, device=cuda))
    assert len(chunk.capture_seconds) == 1


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda) -> None:
    calls = []

    def syncing(image, state):
        calls.append(1)
        # A host read: legal eagerly, refused inside a capture.
        scale = float(image.abs().max()) + 1.0
        return image / scale, state, StepAux(
            image.sum(), image.sum(), image.sum(),
            torch.ones((), dtype=torch.int64, device=image.device),
        )

    state = AdamState(*(torch.zeros(3, device=cuda) for _ in range(2)),
                      torch.zeros((), dtype=torch.int32, device=cuda))
    with pytest.raises(RuntimeError, match="never run eagerly"):
        step.chunked(syncing)(torch.ones(3, device=cuda), state, 3)
    # The warm-up step and the capture's attempt: no eager steps after.
    assert len(calls) == 2
