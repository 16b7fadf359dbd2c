"""The control fails the check, on the card.

The control is the port at the configuration's ``control_precision``
(TF32, the nearest precision below the fp32 the ``mixed`` tier
computes): the same entry, sizes and seeds as a measured run, through
``run.py --control``. On the chip it is read at each cell's own size;
here each cell runs one short window of it, the mesh cell with its
four ranks sharing one card over gloo (``--share-card``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [
    ("vgg19-lbfgs.512-timelapse", ()),
    ("vgg16-adam.720p-final", ()),
    ("vgg19-lbfgs.512-styles4", ()),
    ("vgg19-lbfgs.1024-styles4-mesh2x2", ("--share-card",)),
]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize(("cell", "extra"), CELLS)
def test_the_control_is_not_correct(card, cell, extra) -> None:
    proc = subprocess.run(  # noqa: S603 - fixed argv
        [sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload",
         cell, "--seed", str(2**31 + 901), "--seconds", "1", "--control",
         *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=False,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
