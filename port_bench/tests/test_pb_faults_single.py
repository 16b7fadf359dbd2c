"""A rehearsal of each single-image cell proves correct, and each fault the
cell can have, planted under its timed path, makes ``correct`` false.

The rehearsal skips the look for a card and drives the rest of a run
on the CPU at the mix's rehearsal sizes, with the limits the chip
readings set.
"""
from __future__ import annotations

import pytest

from port_bench.tests.rehearse import check_rehearsal

FAULTS = ["state_unchanged", "half_batch", "altered_answer"]
CELLS = ["vgg19-lbfgs.512-timelapse", "vgg16-adam.720p-final"]
CASES = [(cell, None) for cell in CELLS] + [
    (cell, fault) for cell in CELLS for fault in FAULTS
]


@pytest.mark.parametrize(("cell", "fault"), CASES)
def test_rehearsal_correct_only_without_a_fault(cell, fault) -> None:
    check_rehearsal(cell, fault)
