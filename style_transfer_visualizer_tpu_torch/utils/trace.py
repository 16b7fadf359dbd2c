"""The port's spans: named ranges of host time in a ``torch.profiler``
trace.

A span is a ``torch.profiler.record_function`` range, so it lands in
the same Kineto trace as the card's kernels, on one clock. Spans are
on exactly while a profiler records on the calling thread (a user's
``--profile-dir`` or a benchmark's traced run); otherwise :func:`span`
hands back one shared no-op and costs one C call. A span nests inside
the span of its caller on the same thread, so the nesting names what
caused it. Every name is in :data:`SPANS`:

- entry: ``stv.entry`` (``main.prepare_model_and_input``,
  ``main.prepare_multi_style``), its targets, starting image and step
  build (``.targets``, ``.start``, ``.build``);
- loop: ``stv.loop`` (``OptimizationRunner.run``,
  ``main.run_multi_style_loop``), each blocking device-to-host read of
  losses (``.read``), each checkpoint saved (``.checkpoint``), the
  end of the single run's loop: synchronize and gather (``.final``);
- dispatch: a CUDA graph's capture (``stv.dispatch.capture``, with its
  eager ``.warmup`` step and its cache flush and ``.graph`` capture
  inside), each graphed dispatch of k steps (``.replay``) and each
  eager one (``.eager``);
- step: the L-BFGS direction (``stv.step.direction``), seen only in
  eager steps and at a capture: a replayed graph runs no host code;
- frames: each frame handed towards the host (``stv.frames.submit``);
- parallel: the gathers of rows and styles (``stv.parallel.gather``).
  The halo exchanges and the sums over the ranks, dozens of collectives
  a step, have no span each: spans around them lengthen a traced mesh
  step and so move what the trace measures.
"""
from __future__ import annotations

import contextlib
import functools

import torch

SPANS = (
    "stv.entry",
    "stv.entry.targets",
    "stv.entry.start",
    "stv.entry.build",
    "stv.loop",
    "stv.loop.read",
    "stv.loop.checkpoint",
    "stv.loop.final",
    "stv.dispatch.capture",
    "stv.dispatch.warmup",
    "stv.dispatch.graph",
    "stv.dispatch.replay",
    "stv.dispatch.eager",
    "stv.step.direction",
    "stv.frames.submit",
    "stv.parallel.gather",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records on this thread, else the shared no-op context."""
    if torch.autograd._profiler_enabled():  # noqa: SLF001
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
