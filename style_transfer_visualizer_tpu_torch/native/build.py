"""Compile ``csrc/*.cu`` with ``nvcc`` at first use and load via ctypes.

Each source becomes its own shared library with a plain C interface,
built for ``sm_90a`` into ``build/kernels/`` inside the package, next
to ``csrc/``, so a checkout and an installed copy each build in their
own tree. A library's file name carries a hash of its source, of every
``csrc/`` header the source includes (directly or through another
header) and of the flags, so an edited source or header is rebuilt and
an unchanged one is reused. All
sources build in parallel (one ``nvcc`` process each). A build that
fails raises; nothing falls back to the plain PyTorch versions.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build" / "kernels"
SOURCES = ("conv3x3", "gram")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# tf32x3::kTensorMapError of csrc/tf32x3.cuh.
_TENSOR_MAP_ERROR = 10000

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuiltKernel:
    """One compiled source: its library path and the compiler's report."""

    name: str
    library: Path
    ptxas_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _CUDA_NVCC.exists():
        return str(_CUDA_NVCC)
    msg = "nvcc not found; the CUDA kernels cannot be built"
    raise RuntimeError(msg)


def local_headers(src: Path) -> list[Path]:
    """The ``csrc/`` headers ``src`` includes, directly or not, in order."""
    found: list[Path] = []
    todo = [src]
    while todo:
        for inc in _LOCAL_INCLUDE.findall(todo.pop().read_bytes()):
            header = CSRC / inc.decode()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> list[BuiltKernel]:
    """Build every named source that is not built yet, in parallel.

    Returns one :class:`BuiltKernel` per name; raises ``RuntimeError``
    with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    built: list[BuiltKernel] = []
    for name in names:
        src, lib = _target(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            text = log.read_text() if log.exists() else ""
            built.append(BuiltKernel(name, lib, text))
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(  # noqa: S603 - fixed argv, no shell
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            lib,
        )
    failures: list[str] = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name} (rc {proc.returncode}):\n{out}")
            continue
        tmp.replace(lib)
        lib.with_suffix(".log").write_text(out)
        built.append(BuiltKernel(name, lib, out))
    if failures:
        msg = "nvcc failed for " + "\n".join(failures)
        raise RuntimeError(msg)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (kernel,) = build_all((name,))
            lib = ctypes.CDLL(str(kernel.library))
            _loaded[name] = lib
        return lib


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once.

    The launch plans size their grids by it.
    """
    import torch  # noqa: PLC0415 - the build itself needs no torch

    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict[int, object] = {}


def arrival_counters(device, count: int):
    """Zeroed int32 arrival counters on a CUDA device, kept between calls.

    The kernels that sum split partials take a ticket from a counter
    per output tile; the last block to arrive sets it back to 0, so the
    counters need no clearing launch between calls. One buffer per
    device serves every kernel: launches on one stream do not overlap.
    """
    import torch  # noqa: PLC0415

    index = torch.device(device).index or 0
    # Autograd runs the backward's launches on a thread of its own.
    with _lock:
        have = _counters.get(index)
        if have is None or have.numel() < count:
            have = torch.zeros(
                max(count, 4096), dtype=torch.int32, device=device,
            )
            _counters[index] = have
        return have


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status >= _TENSOR_MAP_ERROR:
        msg = (
            f"{what}: TMA tensor map refused (CUresult "
            f"{status - _TENSOR_MAP_ERROR})"
        )
        raise RuntimeError(msg)
    if status != 0:
        msg = f"{what} launch failed with cudaError {status}"
        raise RuntimeError(msg)


@dataclass
class LaunchCounter:
    """Number of kernel launches a wrapper has made.

    The wrapper adds one where it launches its kernel and nowhere else,
    so a run can show that its main path went through the kernel.
    """

    name: str
    count: int = 0

    def reset(self) -> None:
        """Set the count back to zero."""
        self.count = 0
