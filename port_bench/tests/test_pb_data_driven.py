"""A configuration, a traffic mix and a per-layer metric are added as
new files and entries, and the harness finds and rehearses them with
no file that was there edited."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from port_bench.tests.rehearse import rehearse

REPO = Path(__file__).resolve().parents[2]
PORT = "style_transfer_visualizer_tpu_torch"


def _digests(root: Path) -> dict[str, str]:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def _copy(root: Path) -> Path:
    """A checkout's benchmark and port under ``root``; its benchmark
    folder."""
    shutil.copy(REPO / "BENCHMARK.json", root)
    skip = shutil.ignore_patterns("__pycache__", "build")
    shutil.copytree(REPO / "port_bench", root / "port_bench", ignore=skip)
    shutil.copytree(REPO / PORT, root / PORT, ignore=skip)
    return root / "port_bench"


def _add_cell(root: Path, name: str, config: str, traffic: str, metric: str) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": name, "config": config, "traffic": traffic, "chips": 1,
        "why": "a throwaway",
    })
    for entry in bench["end_to_end"] + bench["per_layer"]:
        if entry["name"] in {"step_ms", metric}:
            entry["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_make_a_new_cell_and_metric(tmp_path) -> None:
    bench_dir = _copy(tmp_path)
    before = _digests(bench_dir)

    config = json.loads((bench_dir / "configs" / "vgg19-lbfgs.json").read_text())
    config.update(
        architecture="vgg16", style_layers=[0, 5, 10, 17, 24],
        content_layers=[19],
        cfg=[64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
             "M", 512, 512, 512, "M"],
    )
    (bench_dir / "configs" / "vgg16-lbfgs.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "96-two-images.json").write_text(json.dumps({
        "entry": "single", "content": [96, 96], "styles": [[64, 128]],
        "steps": 6, "frames": True, "save_every": 3, "log_every": 3,
        "coarse_steps": 0, "warmup_steps": 3,
        "image": {"content_cells": 16, "style_cells": 4, "noise": 0.1},
        "rehearsal": {},
    }))
    (bench_dir / "metrics" / "traced_images.py").write_text(
        "def read(view):\n    return float(len(view.ranks))\n",
    )
    (bench_dir / "limits" / "vgg16-lbfgs.96-two-images.json").write_text(
        (bench_dir / "limits" / "vgg19-lbfgs.512-timelapse.json").read_text(),
    )
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "vgg16-lbfgs", "source": "https://arxiv.org/abs/1409.1556",
        "file": "port_bench/configs/vgg16-lbfgs.json", "reduced": [],
        "why": "a throwaway",
    })
    bench["workloads"].append({
        "name": "vgg16-lbfgs.96-two-images", "config": "vgg16-lbfgs",
        "traffic": "96-two-images", "chips": 1, "why": "a throwaway",
    })
    bench["per_layer"].append({
        "name": "traced_images.single", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "step", "moves": "step_ms",
        "workloads": ["vgg16-lbfgs.96-two-images"],
    })
    for metric in bench["end_to_end"]:
        if metric["name"] == "step_ms":
            metric["workloads"].append("vgg16-lbfgs.96-two-images")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code, line, err = rehearse(
        "vgg16-lbfgs.96-two-images", "--trace", "1", root=tmp_path,
    )
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line
    # A traced window holds an untraced image beside the traced one.
    assert line["images"] >= 2
    assert line["steps"] == 6 * line["images"]
    assert line["readers_answered"] == 1
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_a_mix_shards_rows_and_sets_port_fields_without_an_edit(tmp_path) -> None:
    """A single image over two row-sharded ranks (gloo), its losses read
    from the port's CSV, with fields of the port's configuration set
    from the mix's ``port`` object."""
    bench_dir = _copy(tmp_path)
    before = _digests(bench_dir)
    (bench_dir / "traffic" / "64-rows2-csv.json").write_text(json.dumps({
        "entry": "single", "content": [64, 64], "styles": [[64, 64]],
        "mesh": {"space": 2}, "steps": 4, "frames": False, "save_every": 20,
        "log_every": 10, "loss_csv": True, "coarse_steps": 0,
        "warmup_steps": 2,
        "image": {"content_cells": 8, "style_cells": 4, "noise": 0.05},
        "port": {"output": {"log_every": 1}},
        "rehearsal": {},
    }))
    name = "vgg19-lbfgs.64-rows2-csv"
    (bench_dir / "limits" / f"{name}.json").write_text(
        (bench_dir / "limits" / "vgg19-lbfgs.512-timelapse.json").read_text(),
    )
    _add_cell(tmp_path, name, "vgg19-lbfgs", "64-rows2-csv", "mfu_pct.single")

    code, line, err = rehearse(name, root=tmp_path)
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line
    assert line["steps"] == 4 * line["images"]
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_a_field_the_port_lacks_is_refused(tmp_path) -> None:
    bench_dir = _copy(tmp_path)
    mix = json.loads((bench_dir / "traffic" / "512-timelapse.json").read_text())
    mix["port"] = {"optimization": {"no_such_field": 1}}
    (bench_dir / "traffic" / "512-timelapse.json").write_text(json.dumps(mix))

    code, line, err = rehearse("vgg19-lbfgs.512-timelapse", root=tmp_path)
    assert code != 0
    assert line is None
    assert "optimization.no_such_field" in err
