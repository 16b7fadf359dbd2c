"""The mesh cell's readers: ``rank_peak_bytes`` (end to end) and
``style_rate`` (per layer), and the cell's metrics as ``BENCHMARK.json``
names them."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench import harness

MESH = "vgg19-lbfgs.1024-styles4-mesh2x2"


def _record(t_entry: float, t_end: float, steps: int = 200, styles: int = 2) -> dict:
    return {"t_entry": t_entry, "t_end": t_end, "steps": steps, "styles": styles}


@pytest.mark.parametrize(("peaks", "want"), [
    ([3_137_415_168, 3_100_000_000, 2_900_000_000, 3_000_000_000], 3_137_415_168),
    ([1_137_209_856], 1_137_209_856),
    ([0, 0], None),
    ([], None),
])
def test_rank_peak_bytes_reads_the_fullest_card(peaks, want) -> None:
    read = harness._reader(str(harness.ROOT), "rank_peak_bytes")
    assert read(SimpleNamespace(peaks=peaks)) == want


@pytest.mark.parametrize(("traced", "want"), [
    # The traced image (the first) is left out: 2 x 200 x 2 over 10 s.
    (True, 80.0),
    # Untraced, every image counts: 3 x 200 x 2 over 20.5 s.
    (False, 1200 / 20.5),
])
def test_style_rate_leaves_out_the_traced_image(traced, want) -> None:
    records = [_record(0.0, 10.0), _record(10.5, 15.5), _record(15.5, 20.5)]
    view = SimpleNamespace(records=records, ranks=[{}] if traced else [])
    read = harness._reader(str(harness.ROOT), "style_rate.mesh")
    assert read(view) == pytest.approx(want)


def test_style_rate_reads_nothing_without_an_untraced_image() -> None:
    view = SimpleNamespace(records=[_record(0.0, 10.0)], ranks=[{}])
    assert harness._reader(str(harness.ROOT), "style_rate.mesh")(view) is None


def test_the_mesh_cell_reports_memory_end_to_end_and_its_rate_per_layer() -> None:
    """Its rate spreads too widely for any bound (20-28% of the median
    between runs), so the cell's end-to-end metrics are ``setup_s`` and
    ``rank_peak_bytes``, and every per-layer metric of it moves the
    latter; ``style_steps_per_s`` stays end to end on 512-styles4."""
    cell = harness.load_cell(MESH)
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s", "rank_peak_bytes"]
    assert {m["moves"] for m in cell["per_layer"]} == {"rank_peak_bytes"}
    assert "style_rate.mesh" in {m["name"] for m in cell["per_layer"]}
    batch = harness.load_cell("vgg19-lbfgs.512-styles4")
    assert [m["name"] for m in batch["end_to_end"]] == ["setup_s", "style_steps_per_s"]
    assert all(m["name"].endswith(".batch") for m in batch["per_layer"])


def test_view_carries_every_ranks_peak() -> None:
    cell = harness.load_cell(MESH)
    first = {"setup_s": 1.0, "window_s": 2.0, "records": [], "peak": 5, "summary": None}
    result = {"ranks": [first, {**first, "peak": 9}, {**first, "peak": 7}]}
    assert harness.View(cell, result, 4).peaks == [5, 9, 7]
