"""Prints the port's spans of a run's traced image
(``run.py --trace 1 --plant port_bench.tests.span_probe:attach``).

``attach`` wraps ``trace.summarize`` in the process that calls it (every
rank of a mesh calls it): the summary is unchanged, and each process
prints one line to standard error, ``port_bench.spans`` and a JSON
object holding its rank and :func:`port_bench.spans.summarize` of the
same events. :func:`parse` reads the lines back.
"""
from __future__ import annotations

import json
import sys

import torch

from port_bench import spans, trace

TAG = "port_bench.spans"


def attach() -> None:
    """Print each traced image's spans when the run summarizes it."""
    real = trace.summarize

    def summarize(prof, top: int = 10) -> dict:
        out = real(prof, top)
        rank = (
            torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0
        )
        found = spans.summarize(prof.profiler.kineto_results.events())
        print(TAG, json.dumps({"rank": rank, "spans": found}),
              file=sys.stderr, flush=True)
        return out

    trace.summarize = summarize


def parse(stderr: str) -> dict[int, dict]:
    """Each rank's spans from a run's standard error."""
    found = {}
    for line in stderr.splitlines():
        if line.startswith(TAG + " "):
            entry = json.loads(line[len(TAG) + 1:])
            found[entry["rank"]] = entry["spans"]
    return found
