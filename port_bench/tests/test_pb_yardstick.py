"""The frozen yardstick against the port's own counts.

The FLOPs equal ``utils/flops.py``'s at the four cells' shapes, and
the launches worked out from the shapes equal the conv and Gram calls
the port's entry makes on the CPU (the same code path that launches
the kernels on the card) at each one-card cell's rehearsal sizes.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.yardstick import flops as frozen
from port_bench.yardstick.launches import image_launches

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
    assert frozen.step_flops(config, height, width) == flops.step_flops(
        arch.layer_table, height, width, tuple(config["style_layers"]),
        tuple(config["content_layers"]),
    )


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
