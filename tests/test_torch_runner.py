"""The port's step loop, loss ring, CSV and frame stream, on the CPU.

Each loop test drives the port's ``OptimizationRunner`` and the JAX
package's with the same scripted update (a fixed image recurrence and
float32 losses that depend only on the step), so both see the same
numbers: histories, logged rows, CSV text, frame steps and frame bytes
must be equal (tolerance zero; ``normalize`` is off so the frames are
one multiply and a round on both sides). The frame stream is tested on
its own: FIFO order, backpressure from a slow sink, a sink error raised
at the next submit or at close, and arrays that later frames never
overwrite. The pinned-buffer path needs a card: it is tested in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.engine import runner as jax_runner
from style_transfer_visualizer_tpu.engine.loss_accumulator import (
    LossAccumulator as JaxLossAccumulator,
)
from style_transfer_visualizer_tpu.engine.loss_logger import (
    LossCSVLogger as JaxLossCSVLogger,
)
from style_transfer_visualizer_tpu.engine.optimizers import (
    StepAux as JaxStepAux,
)
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.engine import runner
from style_transfer_visualizer_tpu_torch.engine.loss_accumulator import (
    LossAccumulator,
)
from style_transfer_visualizer_tpu_torch.engine.loss_logger import (
    LossCSVLogger,
)
from style_transfer_visualizer_tpu_torch.engine.optimizers import StepAux
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream


def _losses(step: int) -> tuple[np.float32, np.float32, np.float32]:
    style = np.float32(1.0) / np.float32(step)
    content = np.float32(0.5) * np.float32(step)
    return style, content, np.float32(2.0) * style + content


# --- aligned_chunk ---------------------------------------------------------

@pytest.mark.parametrize(
    "cadences",
    [[], [10], [10, 3], [20, 20], [60], [60, 90], [7], [100, 100], [1]],
)
def test_aligned_chunk_matches_jax(cadences) -> None:
    assert runner.aligned_chunk(cadences) == jax_runner.aligned_chunk(
        cadences,
    )


# --- the loss ring ------------------------------------------------------------

def _pair(track: bool, log_every: int = 3, capacity: int = 4):
    kw = {
        "log_every": log_every, "history_capacity": capacity,
        "track_history": track,
    }
    return LossAccumulator(**kw), JaxLossAccumulator(**kw)


def _logged(row):
    if row is None:
        return None
    return row.step, row.style_loss, row.content_loss, row.total_loss


@pytest.mark.parametrize("track", [True, False])
def test_ring_capacity_4_over_7_steps_matches_jax(track) -> None:
    ours, ref = _pair(track)
    for step in range(1, 8):
        vals = _losses(step)
        got = ours.accumulate(step, *(torch.tensor(v) for v in vals))
        want = ref.accumulate(step, *(jnp.asarray(v) for v in vals))
        assert _logged(got) == _logged(want)
    assert ours.history_truncated == ref.history_truncated == track
    assert ours.export_history() == ref.export_history()
    assert _logged(ours.latest()) == _logged(ref.latest())
    if track:
        assert ours.export_history()["total_loss"] == [
            float(_losses(s)[2]) for s in range(4, 8)
        ]


@pytest.mark.parametrize("chunks", [[2, 3, 2], [7], [1, 5, 1], [4, 3]])
def test_ring_chunks_match_jax(chunks) -> None:
    ours, ref = _pair(True)
    first = 1
    for k in chunks:
        rows = np.array([_losses(s) for s in range(first, first + k)])
        got = ours.accumulate_batch(
            first, *(torch.from_numpy(rows[:, i].copy()) for i in range(3)),
        )
        want = ref.accumulate_batch(
            first, *(jnp.asarray(rows[:, i]) for i in range(3)),
        )
        assert _logged(got) == _logged(want)
        first += k
    assert ours.history_truncated == ref.history_truncated
    assert ours.export_history() == ref.export_history()


def test_csv_logger_text_matches_jax(tmp_path) -> None:
    paths = (tmp_path / "ours.csv", tmp_path / "ref.csv")
    for cls, path in zip((LossCSVLogger, JaxLossCSVLogger), paths):
        with cls(path, 3) as log:
            for step in range(1, 8):
                log.log(step, *(float(v) for v in _losses(step)))
    assert paths[0].read_text() == paths[1].read_text()
    assert len(paths[0].read_text().splitlines()) == 3


# --- the loop, against the JAX runner -------------------------------------------

class ListSink:
    """A sink that keeps every frame it is given, as given."""

    def __init__(self) -> None:
        self.frames: list[np.ndarray] = []
        self._size = None

    def append_data(self, frame: np.ndarray) -> None:
        self.frames.append(frame)

    def close(self) -> None:
        pass


class Quiet:
    """A progress reporter that shows nothing."""

    def update(self, n=1):
        del n

    def set_postfix(self, *args, **kwargs):
        del args, kwargs

    def close(self):
        pass


_IMG0 = np.random.default_rng(0).uniform(0, 1, (1, 6, 8, 3)).astype(
    np.float32,
)


def _torch_fns():
    def update(img, step):
        step = step + 1
        vals = [torch.tensor(v) for v in _losses(step)]
        aux = StepAux(vals[2], vals[0], vals[1], torch.tensor(1))
        return img * 0.75 + 0.2, step, aux

    def chunked(img, step, k):
        auxes = []
        for _ in range(k):
            img, step, aux = update(img, step)
            auxes.append(aux)
        return img, step, StepAux(*(
            torch.stack([getattr(a, f) for a in auxes])
            for f in ("loss", "style_score", "content_score", "n_evals")
        ))

    return update, chunked


def _jax_fns():
    def update(img, step):
        step = step + 1
        vals = [jnp.asarray(v) for v in _losses(step)]
        aux = JaxStepAux(vals[2], vals[0], vals[1], jnp.asarray(1))
        return img * np.float32(0.75) + np.float32(0.2), step, aux

    def chunked(img, step, k):
        auxes = []
        for _ in range(k):
            img, step, aux = update(img, step)
            auxes.append(aux)
        return img, step, JaxStepAux(*(
            jnp.stack([getattr(a, f) for a in auxes])
            for f in ("loss", "style_score", "content_score", "n_evals")
        ))

    return update, chunked


def _configs(tmp_path, *, steps, log_every, save_every, csv, intro):
    output = {
        "output": str(tmp_path), "log_every": log_every,
        "log_loss": str(tmp_path / "{}.csv") if csv else None,
    }
    video = {
        "save_every": save_every, "gif_include_intro": intro,
        "create_gif": True,
    }
    opt = {"steps": steps, "normalize": False}
    jax_cfg = JaxConfig.model_validate({
        "output": {**output, "log_loss": output["log_loss"] and
                   output["log_loss"].format("ref")},
        "optimization": opt, "video": video,
        "hardware": {"device": "cpu"},
    })
    cfg = StyleTransferConfig(
        output=OutputConfig(**{**output, "log_loss": output["log_loss"] and
                               output["log_loss"].format("ours")}),
        optimization=OptimizationConfig(**opt),
        video=VideoConfig(**video),
        hardware=HardwareConfig(device="cpu"),
    )
    return cfg, jax_cfg


def _run_both(tmp_path, *, async_frames=True, intro=False, **kw):
    cfg, jax_cfg = _configs(tmp_path, intro=intro, **kw)
    intro_frame = np.full((6, 8, 3), 200, np.uint8) if intro else None
    results = []
    for mod, fns, img, conf in (
        (runner, _torch_fns(), torch.from_numpy(_IMG0.copy()), cfg),
        (jax_runner, _jax_fns(), jnp.asarray(_IMG0), jax_cfg),
    ):
        sink, steps_seen = ListSink(), []
        update, chunked = fns
        run = mod.OptimizationRunner(
            update, 0, img, conf,
            progress_bar=Quiet(),
            callbacks=mod.OptimizationCallbacks(
                on_video_frame=lambda _f, s, seen=steps_seen: seen.append(s),
            ),
            gif_collector=sink,
            intro_last_frame=intro_frame,
            intro_crossfade_frames=3 if intro else 0,
            async_frames=async_frames,
            chunked_update_fn=chunked,
        )
        image, history, _ = run.run()
        results.append({
            "image": np.asarray(image),
            "history": history,
            "frames": sink.frames,
            "steps": steps_seen,
            "latest": _logged(run.latest_logged),
        })
    return results


@pytest.mark.parametrize(
    ("steps", "log_every", "save_every", "csv"),
    [(7, 3, 1, False), (7, 3, 2, True), (10, 10, 3, False),
     (10, 10, 3, True), (12, 4, 6, True), (3000, 1000, 1000, False)],
)
def test_runner_matches_jax(tmp_path, steps, log_every, save_every, csv):
    ours, ref = _run_both(
        tmp_path, steps=steps, log_every=log_every,
        save_every=save_every, csv=csv,
    )
    np.testing.assert_array_equal(ours["image"], ref["image"])
    assert ours["history"] == ref["history"]
    if csv:
        assert ours["history"] == {}
        assert (tmp_path / "ours.csv").read_text() == (
            tmp_path / "ref.csv"
        ).read_text()
    else:
        assert len(ours["history"]["total_loss"]) == min(steps, 2048)
    assert ours["latest"] == ref["latest"]
    # Frames fall exactly on the save_every grid, in step order.
    assert ours["steps"] == ref["steps"] == list(
        range(save_every, steps + 1, save_every),
    )
    assert len(ours["frames"]) == len(ref["frames"])
    for a, b in zip(ours["frames"], ref["frames"], strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_intro_crossfade_precedes_first_frame(tmp_path) -> None:
    ours, ref = _run_both(
        tmp_path, steps=6, log_every=10, save_every=2, csv=False,
        intro=True,
    )
    # Three crossfade frames, then the frames of steps 2, 4, 6.
    assert len(ours["frames"]) == len(ref["frames"]) == 6
    for a, b in zip(ours["frames"], ref["frames"], strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert ours["steps"] == [2, 4, 6]
    first = ours["frames"][3]
    assert not np.array_equal(ours["frames"][2], first)


def test_async_frames_equal_synchronous_capture(tmp_path) -> None:
    kw = {"steps": 9, "log_every": 3, "save_every": 1, "csv": False}
    async_run, _ = _run_both(tmp_path, async_frames=True, **kw)
    sync_run, _ = _run_both(tmp_path, async_frames=False, **kw)
    assert len(async_run["frames"]) == 9
    for a, b in zip(async_run["frames"], sync_run["frames"], strict=True):
        np.testing.assert_array_equal(a, b)
    # Every delivered array is its own: no later frame overwrote it.
    ids = {id(f) for f in async_run["frames"]}
    assert len(ids) == 9
    assert len({f.tobytes() for f in async_run["frames"]}) == 9


def test_runner_sink_error_is_raised(tmp_path) -> None:
    cfg, _ = _configs(
        tmp_path, steps=4, log_every=2, save_every=1, csv=False, intro=False,
    )

    class Broken(ListSink):
        def append_data(self, frame):
            msg = "encoder died"
            raise OSError(msg)

    update, chunked = _torch_fns()
    run = runner.OptimizationRunner(
        update, 0, torch.from_numpy(_IMG0.copy()), cfg,
        progress_bar=Quiet(), gif_collector=Broken(),
        chunked_update_fn=chunked,
    )
    with pytest.raises(OSError, match="encoder died"):
        run.run()


def test_runner_uses_and_closes_a_given_frame_stream(tmp_path) -> None:
    cfg, _ = _configs(
        tmp_path, steps=6, log_every=3, save_every=2, csv=False, intro=False,
    )

    class Counting(AsyncFrameStream):
        submits = 0
        closes = 0

        def submit(self, device_frame, deliver):
            Counting.submits += 1
            super().submit(device_frame, deliver)

        def close(self):
            Counting.closes += 1
            super().close()

    sink = ListSink()
    update, chunked = _torch_fns()
    runner.OptimizationRunner(
        update, 0, torch.from_numpy(_IMG0.copy()), cfg,
        progress_bar=Quiet(), gif_collector=sink,
        frame_stream=Counting(max_queue=2), chunked_update_fn=chunked,
    ).run()
    assert (Counting.submits, Counting.closes, len(sink.frames)) == (3, 1, 3)


# --- the frame stream on its own ---------------------------------------------

def test_stream_fifo_order_and_copies() -> None:
    stream = AsyncFrameStream(max_queue=3)
    got: list[np.ndarray] = []
    frame = torch.zeros((4, 5, 3), dtype=torch.uint8)
    for i in range(40):
        frame.fill_(i)  # one tensor, rewritten after each submit
        stream.submit(frame, got.append)
    stream.close()
    assert [int(f[0, 0, 0]) for f in got] == list(range(40))
    assert all(f.shape == (4, 5, 3) and f.dtype == np.uint8 for f in got)


def test_stream_backpressure_with_slow_sink() -> None:
    stream = AsyncFrameStream(max_queue=2)
    started = threading.Event()
    release = threading.Event()
    delivered: list[int] = []

    def slow(frame):
        started.set()
        release.wait(5)
        delivered.append(int(frame[0, 0, 0]))

    submitted: list[int] = []

    def producer():
        for i in range(6):
            stream.submit(torch.full((2, 2, 3), i, dtype=torch.uint8), slow)
            submitted.append(i)

    thread = threading.Thread(target=producer)
    thread.start()
    assert started.wait(5)
    time.sleep(0.2)
    # One frame in the sink, two queued, the fourth submit blocked.
    assert len(submitted) == 3
    release.set()
    thread.join(5)
    stream.close()
    assert delivered == list(range(6))


def test_stream_error_raised_at_next_submit_and_at_close() -> None:
    def broken(_frame):
        msg = "sink rejected the frame"
        raise ValueError(msg)

    frame = torch.zeros((2, 2, 3), dtype=torch.uint8)
    stream = AsyncFrameStream()
    stream.submit(frame, broken)
    with pytest.raises(ValueError, match="rejected"):
        stream.drain()
    stream.submit(frame, broken)
    time.sleep(0.1)
    with pytest.raises(ValueError, match="rejected"):
        stream.submit(frame, lambda f: None)

    stream = AsyncFrameStream()
    stream.submit(frame, broken)
    with pytest.raises(ValueError, match="rejected"):
        stream.close()
    with pytest.raises(RuntimeError, match="after stream close"):
        stream.submit(frame, lambda f: None)


def test_stream_refuses_a_device_without_a_path() -> None:
    stream = AsyncFrameStream()
    with pytest.raises(ValueError, match="No frame path"):
        stream.submit(torch.empty((2, 2, 3), device="meta"), lambda f: None)
    stream.close()
