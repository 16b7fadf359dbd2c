"""Run ``port_bench/run.py --rehearse`` in a fresh process; its last
line, parsed."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def rehearse(workload: str, *extra: str, root: Path = ROOT, seed: int = 2**31 + 11):
    """``(exit code, last stdout line as JSON or None, stderr)``."""
    proc = subprocess.run(  # noqa: S603 - fixed argv
        [
            sys.executable, str(root / "port_bench" / "run.py"),
            "--workload", workload, "--seed", str(seed), "--seconds", "0.1",
            "--rehearse", *extra,
        ],
        cwd=root, capture_output=True, text=True, timeout=300, check=False,
    )
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, last, proc.stderr


def check_rehearsal(workload: str, fault: str | None) -> None:
    """A rehearsal is correct without a planted fault and not with one,
    and its line carries no device metric."""
    plant = () if fault is None else (
        "--plant", f"port_bench.tests.faults:{fault}",
    )
    code, line, err = rehearse(workload, *plant)
    assert code == 0, err[-3000:]
    assert line["rehearsal"] is True
    assert line["correct"] is (fault is None), line["checks"]
    assert not {"metrics", "device"} & set(line)
