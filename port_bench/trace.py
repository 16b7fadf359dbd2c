"""One traced image, reduced to what the per-layer metrics read.

``torch.profiler`` records the host's operations and the device's
kernels, copies and sets over one whole image of the window, marked by
the annotation :data:`SPAN`: its per-image set-up on the host, its
targets and every step. :func:`summarize` keeps, for the traced span,
the device time of each kernel name, the busy time (the union of the
device's operation intervals), and the longest idle gaps, each named
by the innermost host operation under its middle.
"""
from __future__ import annotations

import torch

SPAN = "port_bench.image"
_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CUDA = torch.autograd.DeviceType.CUDA


def _device_op(event) -> bool:
    """Whether a profiler event is an operation on the card (a kernel,
    a copy or a set), not an annotation drawn on the device's line."""
    if event.device_type() != _CUDA:
        return False
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in _DEVICE_ACTIVITIES
    annotated = getattr(event, "is_user_annotation", None)
    if annotated is not None and annotated():
        return False
    return not event.name().startswith("port_bench.")


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def _innermost(host, at: int) -> str:
    best = None
    for name, lo, hi in host:
        if lo <= at <= hi and (best is None or hi - lo < best[2] - best[1]):
            best = (name, lo, hi)
    return best[0] if best else "untraced host time"


def summarize(prof, top: int = 10) -> dict:
    """The traced span's ``span_s``, ``busy_s``, ``kernels`` (name to
    ``[count, seconds]``) and ``gaps`` (the ``top`` longest idle
    intervals as ``[host operation, seconds]``)."""
    events = prof.profiler.kineto_results.events()
    spans = [
        (e.start_ns(), e.end_ns()) for e in events
        if e.name() == SPAN and e.device_type() == torch.autograd.DeviceType.CPU
    ]
    if len(spans) != 1:
        msg = f"the trace holds {len(spans)} spans named {SPAN}, not one"
        raise RuntimeError(msg)
    start, end = spans[0]
    device, host = [], []
    for e in events:
        lo, hi = e.start_ns(), e.end_ns()
        if hi < start or lo > end:
            continue
        lo, hi = max(lo, start), min(hi, end)
        if e.device_type() == _CUDA:
            if _device_op(e):
                device.append((e.name(), lo, hi))
        elif e.name() != SPAN:
            host.append((e.name(), lo, hi))
    kernels: dict[str, list] = {}
    for name, lo, hi in device:
        entry = kernels.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (hi - lo) / 1e9
    busy = _union([(lo, hi) for _, lo, hi in device])
    edges = [start, *(t for iv in busy for t in iv), end]
    idle = sorted(
        ((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
        reverse=True,
    )[:top]
    return {
        "span_s": (end - start) / 1e9,
        "busy_s": sum(hi - lo for lo, hi in busy) / 1e9,
        "kernels": kernels,
        "gaps": [
            [_innermost(host, lo + length // 2), length / 1e9]
            for length, lo in idle if length > 0
        ],
    }
