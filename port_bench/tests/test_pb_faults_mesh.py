"""A rehearsal of the mesh cell (gloo ranks) proves correct, and each fault the
cell can have, planted under its timed path, makes ``correct`` false.

The rehearsal skips the look for a card and drives the rest of a run
on the CPU at the mix's rehearsal sizes, with the limits the chip
readings set.
"""
from __future__ import annotations

import pytest

from port_bench.tests.rehearse import check_rehearsal

FAULTS = [
    "state_unchanged", "half_batch", "altered_answer", "scale_swapped", "no_exchange",
]
CELL = "vgg19-lbfgs.1024-styles4-mesh2x2"


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_rehearsal_correct_only_without_a_fault(fault) -> None:
    check_rehearsal(CELL, fault)
