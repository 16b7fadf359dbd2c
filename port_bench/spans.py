"""The port's own spans over one traced image, and the readings they give.

The port marks its layer boundaries with ``torch.profiler`` ranges
named ``stv.*`` (``style_transfer_visualizer_tpu_torch/utils/trace.py``),
on the host, in the same trace as the card's kernels and on the same
clock. :func:`summarize` reduces the events of a run's traced image
(``trace.SPAN``) to what :func:`readings` reads: each ``stv.*`` name's
count and seconds, the self seconds of ``stv.loop`` (its intervals less
the parts other ``stv.*`` spans on its thread cover), ``inside_s``, the
device's idle time inside the harness's calls into the program
(:data:`CALLS`), and ``unexplained_s``, the part of it that no
``stv.*`` span covers.

A device operation is what ``trace`` counts as one (its
``_device_op``): a ``stv.*`` annotation that the profiler draws on the
device's line is not.
"""
from __future__ import annotations

import torch

from port_bench import trace

PREFIX = "stv."
#: The harness's ranges around its calls into the program.
CALLS = ("port_bench.prepare", "port_bench.loop")
_CPU = torch.autograd.DeviceType.CPU


def _ns(intervals) -> int:
    return sum(hi - lo for lo, hi in intervals)


def _intersect(a: list[tuple[int, int]], b: list[tuple[int, int]]):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def summarize(events) -> dict:
    """The ``stv.*`` spans of the one traced image among ``events``:
    ``{"names": {name: {"count", "s"}}, "loop_self_s", "inside_s",
    "unexplained_s"}``."""
    images = [
        (e.start_ns(), e.end_ns()) for e in events
        if e.name() == trace.SPAN and e.device_type() == _CPU
    ]
    if len(images) != 1:
        msg = f"the trace holds {len(images)} spans named {trace.SPAN}"
        raise RuntimeError(msg)
    start, end = images[0]
    spans, calls, device = [], [], []
    for e in events:
        lo, hi = max(e.start_ns(), start), min(e.end_ns(), end)
        if lo > hi:
            continue
        if trace._device_op(e):  # noqa: SLF001
            device.append((lo, hi))
        elif e.device_type() == _CPU and e.name().startswith(PREFIX):
            spans.append((e.name(), lo, hi, e.start_thread_id()))
        elif e.device_type() == _CPU and e.name() in CALLS:
            calls.append((lo, hi))
    names: dict[str, dict] = {}
    loop_self = 0
    for k, (name, lo, hi, thread) in enumerate(spans):
        entry = names.setdefault(name, {"count": 0, "s": 0.0})
        entry["count"] += 1
        entry["s"] += (hi - lo) / 1e9
        if name == "stv.loop":
            inner = trace._union([  # noqa: SLF001
                (s[1], s[2]) for j, s in enumerate(spans)
                if j != k and s[3] == thread and lo <= s[1] and s[2] <= hi
            ])
            loop_self += hi - lo - _ns(inner)
    busy = trace._union(device)  # noqa: SLF001
    edges = [start, *(t for iv in busy for t in iv), end]
    idle = [
        (edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
        if edges[i + 1] > edges[i]
    ]
    inside = _intersect(idle, trace._union(calls))  # noqa: SLF001
    spanned = trace._union([(s[1], s[2]) for s in spans])  # noqa: SLF001
    covered = _intersect(inside, spanned)
    return {
        "names": names,
        "loop_self_s": loop_self / 1e9,
        "inside_s": _ns(inside) / 1e9,
        "unexplained_s": (_ns(inside) - _ns(covered)) / 1e9,
    }


def _field(spans: dict, name: str, key: str):
    entry = spans["names"].get(name)
    return None if entry is None else entry[key]


def readings(spans: dict, steps: int) -> dict[str, float | None]:
    """One rank's readings from its summary over an image of ``steps``
    steps, ``None`` where the image had nothing to read:

    - ``prepare_s``: seconds of ``stv.entry``;
    - ``capture_s``: seconds of ``stv.dispatch.capture`` (warm-up step,
      cache flush and capture);
    - ``loop_host_ms``: self milliseconds of ``stv.loop`` a step, the
      loop's own host work between the spans under it;
    - ``host_reads``: ``stv.loop.read`` spans a step;
    - ``frame_submit_us``: mean microseconds of ``stv.frames.submit``;
    - ``untraced_idle_pct``: ``100 * unexplained_s / inside_s``.
    """
    loop_self = (
        spans["loop_self_s"] if "stv.loop" in spans["names"] else None
    )
    reads = _field(spans, "stv.loop.read", "count")
    frames = spans["names"].get("stv.frames.submit")
    return {
        "prepare_s": _field(spans, "stv.entry", "s"),
        "capture_s": _field(spans, "stv.dispatch.capture", "s"),
        "loop_host_ms": None if loop_self is None else loop_self * 1e3 / steps,
        "host_reads": None if reads is None else reads / steps,
        "frame_submit_us": (
            None if frames is None else frames["s"] * 1e6 / frames["count"]
        ),
        "untraced_idle_pct": (
            100.0 * spans["unexplained_s"] / spans["inside_s"]
            if spans["inside_s"] > 0 else None
        ),
    }
