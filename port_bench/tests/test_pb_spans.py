"""The port's spans in a traced image (``port_bench/spans.py``).

On synthetic profiler events: each ``stv.*`` name's count and seconds,
the self seconds of ``stv.loop``, the idle inside the harness's calls
into the program and the part no span explains; a ``stv.*`` annotation
on the device's line is no device operation, so ``trace.summarize``'s
kernels and busy time do not move.
Through a CPU rehearsal of the timelapse cell traced (``--trace 1``),
the program's own spans answer the entry, loop and frame readings.
"""
from __future__ import annotations

import pytest
import torch

from port_bench import spans, trace
from port_bench.tests import span_probe
from port_bench.tests.rehearse import rehearse

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _Event:
    """The slice of a Kineto event the summaries read."""

    def __init__(self, name, lo, hi, *, device=CPU, kind="cpu_op", thread=1):
        self._name, self._lo, self._hi = name, lo, hi
        self._device, self._kind, self._thread = device, kind, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._lo

    def end_ns(self):
        return self._hi

    def device_type(self):
        return self._device

    def activity_type(self):
        return self._kind

    def start_thread_id(self):
        return self._thread


class _Prof:
    """What ``trace.summarize`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events) -> None:
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _kernel(lo, hi):
    return _Event("conv3x3_tc_kernel", lo, hi, device=CUDA, kind="kernel")


HARNESS = [
    _Event(trace.SPAN, 0, 1000, kind="user_annotation"),
    _Event("port_bench.prepare", 0, 300, kind="user_annotation"),
    _Event("port_bench.loop", 300, 1000, kind="user_annotation"),
    _kernel(50, 150), _kernel(420, 600), _kernel(650, 900),
]
PROGRAM = [
    _Event("stv.entry", 10, 290), _Event("stv.entry.targets", 20, 100),
    _Event("stv.loop", 310, 990), _Event("stv.dispatch.replay", 400, 500),
    _Event("stv.loop.read", 600, 700), _Event("stv.loop.read", 800, 850),
    # The profiler draws a host range on the device's line too.
    _Event("stv.loop", 310, 990, device=CUDA, kind="gpu_user_annotation"),
]


def _ns(value):
    return pytest.approx(value / 1e9, abs=1e-15)


def test_spans_count_time_loop_self_time_and_idle() -> None:
    found = spans.summarize(HARNESS + PROGRAM)
    want = {
        "stv.entry": (1, 280),
        "stv.entry.targets": (1, 80),
        "stv.loop": (1, 680),
        "stv.dispatch.replay": (1, 100),
        "stv.loop.read": (2, 150),
    }
    assert found["names"] == {
        name: {"count": count, "s": _ns(total)}
        for name, (count, total) in want.items()
    }
    assert found["loop_self_s"] == _ns(680 - 100 - 100 - 50)
    # Idle: [0, 50], [150, 420], [600, 650], [900, 1000], all inside
    # the calls into the program.
    assert found["inside_s"] == _ns(50 + 270 + 50 + 100)
    # Uncovered: [0, 10], [290, 310], [990, 1000].
    assert found["unexplained_s"] == _ns(10 + 20 + 10)


def test_readings_from_the_spans() -> None:
    got = spans.readings(spans.summarize(HARNESS + PROGRAM), steps=10)
    assert got == {
        "prepare_s": _ns(280),
        "capture_s": None,
        "loop_host_ms": pytest.approx(430 / 1e9 * 1e3 / 10),
        "host_reads": pytest.approx(0.2),
        "frame_submit_us": None,
        "untraced_idle_pct": pytest.approx(100 * 40 / 470),
    }


def test_idle_outside_the_calls_is_not_inside() -> None:
    found = spans.summarize([
        _Event(trace.SPAN, 0, 100, kind="user_annotation"),
        _Event("port_bench.loop", 20, 60, kind="user_annotation"),
        _Event("stv.loop", 30, 50), _kernel(40, 45),
    ])
    assert found["inside_s"] == _ns(35)
    assert found["unexplained_s"] == _ns(10 + 10)


def test_a_span_on_another_thread_keeps_the_loop_self_time() -> None:
    """A span on another thread (a backward's, on the autograd thread)
    is no part of the loop's own work on its thread, but it explains
    the idle under it."""
    found = spans.summarize([
        _Event(trace.SPAN, 0, 100, kind="user_annotation"),
        _Event("port_bench.loop", 0, 100, kind="user_annotation"),
        _Event("stv.loop", 0, 60, thread=1),
        _Event("stv.dispatch.eager", 10, 30, thread=1),
        _Event("stv.step.direction", 40, 100, thread=2),
    ])
    assert found["loop_self_s"] == _ns(60 - 20)
    assert found["inside_s"] == _ns(100)
    assert found["unexplained_s"] == 0


def test_an_annotation_on_the_device_line_is_no_device_op() -> None:
    with_spans = trace.summarize(_Prof(HARNESS + PROGRAM))
    without = trace.summarize(_Prof(HARNESS))
    assert set(with_spans["kernels"]) == {"conv3x3_tc_kernel"}
    for got in (with_spans, without):
        assert got["kernels"]["conv3x3_tc_kernel"] == [3, _ns(530)]
        assert got["busy_s"] == _ns(530)
        assert got["span_s"] == _ns(1000)


def test_the_summary_keeps_its_keys_on_a_trace_without_spans() -> None:
    got = trace.summarize(_Prof(HARNESS))
    assert set(got) == {"span_s", "busy_s", "kernels", "gaps"}
    assert got["gaps"] == [
        ["port_bench.prepare", _ns(270)], ["port_bench.loop", _ns(100)],
        ["port_bench.loop", _ns(50)], ["port_bench.prepare", _ns(50)],
    ]
    assert spans.summarize(HARNESS) == {
        "names": {}, "loop_self_s": 0, "inside_s": _ns(470),
        "unexplained_s": _ns(470),
    }


def test_a_traced_rehearsal_answers_the_span_readings() -> None:
    """The timelapse cell, traced on the CPU (no capture there: its
    dispatch is a Python loop)."""
    code, line, err = rehearse(
        "vgg19-lbfgs.512-timelapse", "--trace", "1",
        "--plant", "port_bench.tests.span_probe:attach",
    )
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    (found,) = span_probe.parse(err).values()
    got = spans.readings(found, steps=4)
    assert {k for k, v in got.items() if v is not None} == {
        "prepare_s", "loop_host_ms", "host_reads", "frame_submit_us",
        "untraced_idle_pct",
    }
    # Two loss rows (log_every 2) and the history export, over 4 steps.
    assert got["host_reads"] == 3 / 4
    assert set(found["names"]) <= set(_port_spans())
    assert found["unexplained_s"] <= found["inside_s"]


def _port_spans():
    from style_transfer_visualizer_tpu_torch.utils.trace import SPANS  # noqa: PLC0415

    return SPANS
