"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from one traced
image; both check the window's outputs against the plain reference and
print each number compared beside its limit, as the last lines of
standard error and as the result's last key. The last line of standard
output is the result, one JSON object. A run that cannot report (no
card, fewer cards than the cell asks for, a forbidden module loaded,
a missing file) exits non-zero and prints no result.

``--rehearse`` drives the cell's control flow on the CPU at the sizes
its traffic mix names for a rehearsal and prints a rehearsal line with
no device metric in it. ``--control`` runs the port at the
configuration's ``control_precision`` (the lower precision the check
must catch) and ``--share-card`` puts a mesh's ranks on one card over
gloo: both are for setting and checking the limits, never part of a
measured run.
"""
from __future__ import annotations

import time

T_START = time.time()

# ruff: noqa: E402
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rehearse", action="store_true")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--share-card", action="store_true")
    parser.add_argument("--plant", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    args.root = str(ROOT)
    args.t_start = T_START
    return args


def main(argv: list[str] | None = None) -> int:
    # Keep library code from loading JAX behind the run's back.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from port_bench import harness

    args = _args(argv)
    try:
        out = harness.run(args)
    except harness.RunError as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 2
    for name, value in out["readings"].items():
        if name not in out["checks"]:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, check in out["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
