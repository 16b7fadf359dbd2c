"""The port's spans (``utils/trace.py``) on the CPU.

With no profiler a span is the shared no-op and nothing is recorded.
Under ``torch.profiler`` (host activity only), a tiny single image with
timelapse frames through ``main.prepare_model_and_input`` and
``OptimizationRunner``, and a 2-style batch through
``main.prepare_multi_style`` and ``main.run_multi_style_loop``, emit
their entry, loop, dispatch, read and frame spans, nested as the call
tree nests, and every ``stv.`` name emitted is one of ``SPANS``. A
``profile_dir`` trace of ``main.run_style_transfer`` and of
``main.multi_style_transfer`` holds the entry's spans beside the
loop's. The row-sharded spans (``stv.parallel.*``) are held in
``tests/test_torch_spatial.py``, on its gloo ranks.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch import main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationRunner,
    SilentProgress,
)
from style_transfer_visualizer_tpu_torch.utils import trace

_OPT = {
    "style_layers": [0, 5], "content_layers": [2], "init_method": "content",
    "seed": 0, "allow_random_weights": True, "lbfgs_history_size": 4,
}


class _Sink:
    """An in-memory frame sink."""

    def __init__(self) -> None:
        self.frames: list[np.ndarray] = []

    def append_data(self, frame: np.ndarray) -> None:
        self.frames.append(np.array(frame))

    def close(self) -> None:
        return None


def _config(tmp_path, *, steps: int, optimizer: str = "lbfgs"):
    return StyleTransferConfig(
        output=OutputConfig(output=str(tmp_path), log_every=2,
                            plot_losses=False),
        optimization=OptimizationConfig(
            **_OPT, steps=steps, optimizer=optimizer, lr=0.05,
        ),
        video=VideoConfig(create_video=False, create_gif=True, save_every=2),
        hardware=HardwareConfig(device="cpu"),
    )


def _images(styles: int):
    rng = np.random.default_rng(18)
    content = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    return content, [
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
        for _ in range(styles)
    ]


def _spans(prof) -> list[tuple[str, int, int, int]]:
    """Every ``stv.`` host event: ``(name, start, end, thread)``."""
    return [
        (e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("stv.")
    ]


def _inside(spans, inner: str, outer: str) -> bool:
    """Whether every ``inner`` span lies in some ``outer`` span of its
    thread."""
    outers = [s for s in spans if s[0] == outer]
    return all(
        any(o[1] <= s[1] and s[2] <= o[2] and o[3] == s[3] for o in outers)
        for s in spans if s[0] == inner
    )


def _profiled(fn):
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
    ) as prof:
        fn()
    return _spans(prof)


def test_span_without_a_profiler_is_the_shared_no_op() -> None:
    assert not torch.autograd._profiler_enabled()  # noqa: SLF001
    assert trace.span("stv.loop") is trace.span("stv.entry")
    with trace.span("stv.loop"):
        pass


def test_span_under_a_profiler_records_its_name() -> None:
    def work():
        with trace.span("stv.loop"):
            torch.ones(2).sum()

    assert [s[0] for s in _profiled(work)] == ["stv.loop"]


def test_spanned_keeps_the_function_and_records_each_call() -> None:
    @trace.spanned("stv.entry")
    def double(x):
        """Twice ``x``."""
        return 2 * x

    assert double.__doc__ == "Twice ``x``."
    assert double(3) == 6
    assert [s[0] for s in _profiled(lambda: double(1))] == ["stv.entry"]


def test_span_names_are_unique_and_prefixed() -> None:
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(name.startswith("stv.") for name in trace.SPANS)


@pytest.fixture(scope="module")
def single_spans(tmp_path_factory):
    """The spans of a 4-step single image with a frame every 2 steps."""
    tmp_path = tmp_path_factory.mktemp("single")
    content, (style,) = _images(1)
    config = _config(tmp_path, steps=4)
    sink = _Sink()

    def run():
        bundle, start = main.prepare_model_and_input(content, style, config)
        runner = OptimizationRunner(
            bundle.update_fn, bundle.opt_state, start, config,
            progress_bar=SilentProgress(), gif_collector=sink,
            chunked_update_fn=bundle.chunked_update_fn,
        )
        runner.run()

    spans = _profiled(run)
    assert len(sink.frames) == 2
    return spans


@pytest.mark.parametrize(
    ("name", "count"),
    [("stv.entry", 1), ("stv.entry.targets", 1), ("stv.entry.start", 1),
     ("stv.entry.build", 1), ("stv.loop", 1), ("stv.loop.final", 1),
     ("stv.frames.submit", 2)],
)
def test_single_image_counts_its_spans(single_spans, name, count) -> None:
    assert [s[0] for s in single_spans].count(name) == count


def test_single_image_nests_its_spans(single_spans) -> None:
    names = {s[0] for s in single_spans}
    assert {"stv.dispatch.eager", "stv.loop.read",
            "stv.step.direction"} <= names
    for inner, outer in (
        ("stv.entry.targets", "stv.entry"),
        ("stv.entry.start", "stv.entry"),
        ("stv.entry.build", "stv.entry"),
        ("stv.dispatch.eager", "stv.loop"),
        ("stv.step.direction", "stv.dispatch.eager"),
        ("stv.loop.read", "stv.loop"),
        ("stv.frames.submit", "stv.loop"),
        ("stv.loop.final", "stv.loop"),
    ):
        assert _inside(single_spans, inner, outer), (inner, outer)


def test_single_image_reads_losses_at_the_cadence(single_spans) -> None:
    """Two ``log_every`` reads and the history export at the end."""
    assert [s[0] for s in single_spans].count("stv.loop.read") == 3


@pytest.fixture(scope="module")
def batch_spans(tmp_path_factory):
    """The spans of a 2-style, 4-step batch with frames and a CSV."""
    tmp_path = tmp_path_factory.mktemp("batch")
    content, styles = _images(2)
    config = _config(tmp_path, steps=4, optimizer="adam")
    config.output.log_loss = str(tmp_path / "loss.csv")
    sinks: list[_Sink] = []

    def make_sink(kind: str, name: str) -> _Sink:
        del kind, name
        sinks.append(_Sink())
        return sinks[-1]

    def run():
        bundle, images = main.prepare_multi_style(content, styles, config)
        _, _, errors = main.run_multi_style_loop(
            bundle, images, config, tmp_path, ["a", "b"],
            progress_bar=SilentProgress(), make_sink=make_sink,
        )
        assert errors == []

    spans = _profiled(run)
    assert [len(s.frames) for s in sinks] == [2, 2]
    return spans


@pytest.mark.parametrize(
    ("name", "count"),
    [("stv.entry", 1), ("stv.entry.targets", 1), ("stv.entry.start", 1),
     ("stv.entry.build", 1), ("stv.loop", 1), ("stv.loop.read", 2),
     ("stv.loop.final", 1), ("stv.dispatch.eager", 2),
     ("stv.frames.submit", 2)],
)
def test_batch_counts_its_spans(batch_spans, name, count) -> None:
    assert [s[0] for s in batch_spans].count(name) == count


def test_batch_nests_its_spans(batch_spans) -> None:
    for inner, outer in (
        ("stv.entry.targets", "stv.entry"),
        ("stv.entry.build", "stv.entry"),
        ("stv.dispatch.eager", "stv.loop"),
        ("stv.loop.read", "stv.loop"),
        ("stv.frames.submit", "stv.loop"),
    ):
        assert _inside(batch_spans, inner, outer), (inner, outer)


def test_every_span_emitted_is_named_in_spans(
    single_spans, batch_spans,
) -> None:
    emitted = {s[0] for s in (*single_spans, *batch_spans)}
    assert emitted <= set(trace.SPANS)


def _trace_names(directory) -> list[str]:
    """The ``stv.`` event names of the one trace file in ``directory``."""
    (path,) = directory.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [
        e["name"] for e in events if e.get("name", "").startswith("stv.")
    ]


_ENTRY_AND_LOOP = (
    "stv.entry", "stv.entry.targets", "stv.entry.start", "stv.entry.build",
    "stv.loop",
)


def test_profile_dir_traces_the_single_runs_entry_and_loop(tmp_path) -> None:
    content, (style,) = _images(1)
    config = _config(tmp_path, steps=2)
    config.output.profile_dir = str(tmp_path / "trace")
    main.run_style_transfer(content, style, config)
    names = _trace_names(tmp_path / "trace")
    assert [names.count(name) for name in _ENTRY_AND_LOOP] == [1] * 5


def test_profile_dir_traces_the_batchs_entry_and_loop(tmp_path) -> None:
    from PIL import Image  # noqa: PLC0415

    rng = np.random.default_rng(18)
    paths = []
    for name in "cab":
        paths.append(str(tmp_path / f"{name}.png"))
        pixels = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(paths[-1])
    config = _config(tmp_path / "out", steps=2, optimizer="adam")
    config.video.create_gif = False
    config.output.profile_dir = str(tmp_path / "trace")
    saved = main.multi_style_transfer(paths[0], paths[1:], config)
    assert len(saved) == 2
    names = _trace_names(tmp_path / "trace")
    assert [names.count(name) for name in _ENTRY_AND_LOOP] == [1] * 5
