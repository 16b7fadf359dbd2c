"""The frozen yardstick against the port's own counts.

The FLOPs equal ``utils/flops.py``'s at the four cells' shapes, as
each cell's family gives them and as ``mfu_pct`` reads them, and the
launches worked out from the shapes equal the conv and Gram calls the
port's entry makes on the CPU (the same code path that launches the
kernels on the card) at each one-card cell's rehearsal sizes. A cell
whose family is missing is refused as the run's own error.
"""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from port_bench import families, harness
from port_bench.yardstick import flops as frozen
from port_bench.yardstick.launches import image_launches
from port_bench.yardstick.peaks import TF32_FLOPS

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_step_flops_equal_the_ports(name) -> None:
    from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
    from style_transfer_visualizer_tpu_torch.utils import flops

    cell = harness.load_cell(name)
    config, mix = cell["config"], cell["traffic"]
    arch = get_architecture(config["architecture"])
    height, width = mix["content"]
    ports = flops.step_flops(
        arch.layer_table, height, width, tuple(config["style_layers"]),
        tuple(config["content_layers"]),
    )
    assert frozen.step_flops(config, height, width) == ports
    assert families.load(config).step_flops(config, height, width) == ports


@pytest.mark.parametrize("name", CELLS)
def test_mfu_pct_reads_the_frozen_step_flops(name) -> None:
    """``mfu_pct`` takes its count from the cell's family: the same
    number as the frozen VGG count, over a traced span of 2 s."""
    cell = harness.load_cell(name)
    config, mix = cell["config"], cell["traffic"]
    view = SimpleNamespace(
        config=config, traffic=mix, chips=cell["chips"],
        traced_steps=mix["steps"],
        ranks=[{"summary": {"kernels": {"k": (1, 1.0)}, "span_s": 2.0}}],
    )
    work = (
        frozen.step_flops(config, *mix["content"]) * len(mix["styles"])
        * mix["steps"]
    )
    want = 100.0 * work / (2.0 * cell["chips"] * TF32_FLOPS)
    read = harness._reader(cell["root"], "mfu_pct.single")
    assert read(view) == want


@pytest.mark.parametrize("family", ["no_such_family", "../families/vgg", 7, "lacking"])
def test_a_cell_of_an_unknown_family_is_a_run_error(family, tmp_path, monkeypatch) -> None:
    """Refused when the cell is loaded, before any set-up: a family with
    no file, a name that leaves ``port_bench/families``, a name that is
    no string, and a file that lacks one of the five functions."""
    (tmp_path / "lacking.py").write_text(
        "def make_weights(config, seed, device):\n    return {}\n",
    )
    monkeypatch.setattr(families, "DIR", tmp_path)
    config = json.loads((ROOT / "port_bench/configs/vgg19-lbfgs.json").read_text())
    config["family"] = family
    for folder, data in (
        ("configs/odd.json", config),
        ("traffic/512-timelapse.json", {}),
        ("limits/odd.512-timelapse.json", {}),
    ):
        path = tmp_path / "port_bench" / folder
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "odd.512-timelapse", "config": "odd",
                       "traffic": "512-timelapse", "chips": 1}],
        "end_to_end": [], "per_layer": [],
    }))
    with pytest.raises(harness.RunError, match="family"):
        harness.load_cell("odd.512-timelapse", tmp_path)


def test_the_cells_step_flops() -> None:
    """The numbers PERF.md quotes, fixed."""
    want = {
        "vgg19-lbfgs.512-timelapse": 396_948_930_560,
        "vgg16-adam.720p-final": 1_123_732_684_800,
        "vgg19-lbfgs.1024-styles4-mesh2x2": 1_587_795_722_240,
    }
    for name, flop in want.items():
        cell = harness.load_cell(name)
        assert frozen.step_flops(cell["config"], *cell["traffic"]["content"]) == flop


@pytest.mark.parametrize("name", CELLS)
def test_launch_counts_at_the_cells_shapes(name) -> None:
    """Per image: the targets' sweeps and Grams, then two convs per
    forward conv and one Gram launch per style tap a step."""
    cell = harness.load_cell(name)
    config, mix = cell["config"], cell["traffic"]
    convs_to = {
        tap: sum(
            1 for i, item in enumerate(_conv_indices(config)) if item <= tap
        )
        for tap in (max(config["style_layers"]), max(config["content_layers"]))
    }
    last = max(*config["style_layers"], *config["content_layers"])
    mesh = mix.get("mesh") or {"style": 1}
    local = len(mix["styles"]) // mesh["style"]
    per_step = 2 * sum(1 for i in _conv_indices(config) if i <= last)
    want_conv = (
        local * convs_to[max(config["style_layers"])]
        + convs_to[max(config["content_layers"])]
        + per_step * mix["steps"]
    )
    taps = len(config["style_layers"])
    want_gram = local * taps + taps * mix["steps"]
    convs, grams = image_launches(config, mix)
    assert (len(convs), len(grams)) == (want_conv, want_gram)


def _conv_indices(config) -> list[int]:
    from port_bench.reference.objective import CONV, layer_table

    return [i for i, row in enumerate(layer_table(config["cfg"])) if row[0] == CONV]


@pytest.mark.parametrize(
    "name",
    ["vgg19-lbfgs.512-timelapse", "vgg16-adam.720p-final", "vgg19-lbfgs.512-styles4"],
)
def test_worked_out_launches_equal_the_ports_calls(name, monkeypatch, tmp_path) -> None:
    from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram

    calls = {"conv": 0, "gram": 0}

    def counting(module, attr, key):
        real = getattr(module, attr)

        def count(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, attr, count)

    counting(conv3x3, "conv3x3_apply", "conv")
    counting(gram, "_gram", "gram")
    cell = harness._rehearsal_cell(harness.load_cell(name))
    spec = {
        "cell": cell, "seed": 2**31 + 7, "precision": "mixed",
        "out_dir": str(tmp_path), "plant": None,
    }
    images = harness._Images(spec, torch.device("cpu"), None)
    images.run(0)
    convs, grams = image_launches(cell["config"], cell["traffic"])
    assert calls == {"conv": len(convs), "gram": len(grams)}
