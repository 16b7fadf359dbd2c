"""What the benchmark may import, and where it refuses to run.

Top-level module names are compared whole: the port's name begins
with the JAX package's.
"""
from __future__ import annotations

import ast
import shutil
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.tests.rehearse import rehearse

PACKAGE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "style_transfer_visualizer_tpu"}
PORT = "style_transfer_visualizer_tpu_torch"


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_module_imports_jax_or_the_jax_package(path) -> None:
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PACKAGE / "reference").rglob("*.py")),
    ids=lambda p: p.name,
)
def test_the_reference_imports_nothing_of_the_port(path) -> None:
    imported = _imported(path)
    assert PORT not in imported
    assert imported <= {"__future__", "collections", "torch", "port_bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("port_bench"):
            assert node.module.startswith("port_bench.reference")


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch) -> None:
    import sys
    import types

    monkeypatch.setitem(sys.modules, "style_transfer_visualizer_tpu_torch_x", types.ModuleType("x"))
    assert "style_transfer_visualizer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_measuring_run_without_a_card_fails() -> None:
    """No fallback: without ``--rehearse`` a run needs the card."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    proc = subprocess.run(  # noqa: S603
        [sys.executable, str(PACKAGE / "run.py"), "--workload",
         "vgg19-lbfgs.512-timelapse", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=PACKAGE.parent, capture_output=True, text=True, timeout=120,
        check=False,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path) -> None:
    """With only ``BENCHMARK.json`` and ``port_bench/`` there is no port
    to run: the run exits non-zero and prints no result."""
    shutil.copy(PACKAGE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(
        PACKAGE, tmp_path / "port_bench",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    code, line, err = rehearse("vgg19-lbfgs.512-timelapse", root=tmp_path)
    assert code != 0
    assert line is None
    assert "style_transfer_visualizer_tpu_torch" in err


def test_jax_loaded_after_the_window_leaves_no_result(tmp_path) -> None:
    """A metric reader that loads a module named ``jax`` once the window
    has closed: the run exits non-zero, prints no result and names it."""
    shutil.copy(PACKAGE.parent / "BENCHMARK.json", tmp_path)
    skip = shutil.ignore_patterns("__pycache__", "build")
    shutil.copytree(PACKAGE, tmp_path / "port_bench", ignore=skip)
    shutil.copytree(PACKAGE.parent / PORT, tmp_path / PORT, ignore=skip)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    reader = tmp_path / "port_bench" / "metrics" / "mfu_pct.py"
    reader.write_text(
        "import importlib\nimport sys\nfrom pathlib import Path\n\n\n"
        "def read(view):\n"
        "    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / 'stub'))\n"
        "    importlib.import_module('jax')\n"
        "    return 1.0\n",
    )

    code, line, err = rehearse(
        "vgg19-lbfgs.512-timelapse", "--trace", "1", root=tmp_path,
    )
    assert code != 0
    assert line is None
    assert "jax" in err.splitlines()[-1]
