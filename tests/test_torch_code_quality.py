"""Static gate over the PyTorch/CUDA port and ``chip_smoke.py``.

The port stands alone: it imports neither JAX nor the JAX package (not
even that package's JAX-free modules), and it imports Pillow, pydantic,
tqdm and imageio only inside functions, since the machine with the
card is not known to have them. The docstring, line-length and
exception checks of ``tests/test_code_quality.py`` apply here too.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
PACKAGE = ROOT / "style_transfer_visualizer_tpu_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"
MAX_LINE = 79
_JAX_PACKAGE = re.compile(r"^style_transfer_visualizer_tpu(\.|$)")
_FUNCTION_ONLY = {"PIL", "pydantic", "tqdm", "imageio"}


def _package_sources() -> list[Path]:
    files = sorted(PACKAGE.rglob("*.py"))
    assert files, "port sources not found"
    return files


def _all_sources() -> list[Path]:
    return [*_package_sources(), CHIP_SMOKE]


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _imported_modules(node: ast.AST) -> list[str]:
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def _module_level_nodes(tree: ast.Module):
    """Every node outside function bodies (classes count as module)."""
    stack: list[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def test_chip_smoke_exists() -> None:
    assert CHIP_SMOKE.is_file()


@pytest.mark.parametrize(
    "name",
    [
        "style_transfer_visualizer_tpu",
        "style_transfer_visualizer_tpu.ops.gram",
    ],
)
def test_jax_package_pattern_matches(name) -> None:
    assert _JAX_PACKAGE.match(name)
    assert not _JAX_PACKAGE.match("style_transfer_visualizer_tpu_torch.ops")


def test_no_jax_and_no_jax_package_imports() -> None:
    offenders: list[str] = []
    for path in _all_sources():
        for node in ast.walk(_parse(path)):
            for mod in _imported_modules(node):
                root = mod.split(".")[0]
                if root in ("jax", "jaxlib") or _JAX_PACKAGE.match(mod):
                    offenders.append(f"{path.name}:{node.lineno} {mod}")
    assert not offenders, f"port imports JAX or its package: {offenders}"


def test_optional_packages_only_inside_functions() -> None:
    offenders: list[str] = []
    for path in _all_sources():
        for node in _module_level_nodes(_parse(path)):
            for mod in _imported_modules(node):
                if mod.split(".")[0] in _FUNCTION_ONLY:
                    offenders.append(f"{path.name}:{node.lineno} {mod}")
    assert not offenders, f"module-level optional imports: {offenders}"


def test_modules_have_docstrings() -> None:
    for path in _all_sources():
        assert ast.get_docstring(_parse(path)), f"{path} lacks a docstring"


def test_public_callables_documented() -> None:
    undocumented: list[str] = []
    for path in _all_sources():
        tree = _parse(path)
        tops = [
            node for node in tree.body
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            )
        ]
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            tops.extend(
                node for node in cls.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
        undocumented.extend(
            f"{path.name}:{node.name}"
            for node in tops
            if not node.name.startswith("_") and not ast.get_docstring(node)
        )
    assert not undocumented, f"Missing docstrings: {undocumented}"


def test_line_length_limit() -> None:
    offenders: list[str] = []
    for path in [*_all_sources(), *sorted(PACKAGE.rglob("*.cu"))]:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if len(line) > MAX_LINE and "noqa" not in line:
                offenders.append(f"{path.name}:{lineno} ({len(line)})")
    assert not offenders, f"lines over {MAX_LINE} cols: {offenders[:20]}"


def test_no_bare_except_and_no_prints_in_package() -> None:
    offenders: list[str] = []
    for path in _all_sources():
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                offenders.append(f"{path.name}:{node.lineno} bare except")
            if (
                path != CHIP_SMOKE
                and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                offenders.append(f"{path.name}:{node.lineno} print")
    assert not offenders, offenders
