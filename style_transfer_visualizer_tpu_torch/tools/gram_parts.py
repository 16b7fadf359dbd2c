"""Where a launch of the TF32 Gram kernel spends its time, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.gram_parts

Builds copies of ``csrc/gram.cu`` whose ``gram_tf32_kernel`` leaves out,
cumulatively, the two-level sum of the partial tiles, the products and
the transpose of each slab (what is left streams the slabs through the
TMA ring), each into the package's build directory beside the real
library; then times each copy at the five Gram shapes of the 512x512
main path, alone and at S = 4, beside ``torch.mm`` / ``torch.bmm``
with TF32 on. The copies compute wrong Grams on purpose; nothing but
this tool loads them. Device ms per call from CUDA graphs of 5 calls
replayed twice, the least of two rounds. Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from functools import cache, partial

import torch

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops import gram

SHAPES = [
    (1, 262144, 64), (1, 65536, 128), (1, 16384, 256), (1, 4096, 512),
    (1, 1024, 512), (4, 262144, 64), (4, 65536, 128),
]
_NO_SUM = [(
    "  sum_partials<true>(args, pr, &flag, reinterpret_cast<float*>(smem));",
    "  (void)flag;",
)]
_NO_MMA = [
    ("          mma_ss<kT>(part, db + 2 * kk, db + 2 * kk, scale_d);", ""),
    ("          mma<kT>(part, frag[P][c][kk], db + 2 * kk, scale_d);", ""),
]
_NO_PREP = [
    ("    for (int it = 0; it < kKP1 / 8; ++it) {",
     "    for (int it = 0; it < 0; ++it) {"),
    ("    if (!diag) {\n#pragma unroll\n      for (int c = 0;",
     "    if (false) {\n#pragma unroll\n      for (int c = 0;"),
]
#: Each variant's edits of the TF32 kernel's text, cumulative.
VARIANTS = {
    "whole": [],
    "no sum": _NO_SUM,
    "no sum, no products": _NO_SUM + _NO_MMA,
    "streaming only": _NO_SUM + _NO_MMA + _NO_PREP,
}


def _variant_source(edits: list[tuple[str, str]]) -> str:
    src = (build.CSRC / "gram.cu").read_text()
    start = src.index("gram_tf32_kernel(const __grid_constant__")
    end = src.index("// The IEEE fp32 mode on the CUDA cores")
    body = src[start:end]
    for old, new in edits:
        if old not in body:
            msg = f"gram_parts: {old!r} is no longer in gram_tf32_kernel"
            raise RuntimeError(msg)
        body = body.replace(old, new)
    return src[:start] + body + src[end:]


def _build_variants() -> dict[str, ctypes.CDLL]:
    """One library per variant, built in parallel."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = build.BUILD_DIR / f"gram_parts_{i}.cu"
        cu.write_text(_variant_source(edits))
        lib = cu.with_suffix(".so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS,  # noqa: SLF001
               "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (
            subprocess.Popen(  # noqa: S603 - fixed argv, no shell
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            lib,
        )
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            msg = f"gram_parts: {name} did not build:\n{out}"
            raise RuntimeError(msg)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@cache
def _stream() -> torch.cuda.Stream:
    """The one side stream every capture runs on (a fresh stream per
    timing would leave a cuBLAS workspace behind for each)."""
    return torch.cuda.Stream()


def _graph_ms(fn, reps: int = 5, replays: int = 2) -> float:
    """Device ms of one call, from a CUDA graph of ``reps`` calls."""
    stream = _stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _library_ms(f: torch.Tensor) -> float:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return _graph_ms(partial(torch.bmm, f.mT, f))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def main() -> int:
    """Print the card, then one line per shape: ms per variant."""
    if not torch.cuda.is_available():
        msg = "gram_parts needs a CUDA device"
        raise SystemExit(msg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sys.stdout.write(f"card: {card}\n")
    libs = _build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = {s: torch.randn(s, generator=gen, device="cuda") for s in SHAPES}
    times: dict[tuple[str, tuple], float] = {}
    real_load = build.load
    try:
        for _ in range(2):
            for name, lib in libs.items():
                build.load = lambda _name, lib=lib: lib
                gram._entry.cache_clear()  # noqa: SLF001
                for shape, f in feats.items():
                    ms = _graph_ms(partial(
                        gram.gram_kernel_batched, f, GRAM_MATRIX_CLAMP_MAX,
                        float(shape[1] * shape[2]), "tf32",
                    ))
                    key = (name, shape)
                    times[key] = min(times.get(key, ms), ms)
    finally:
        build.load = real_load
        gram._entry.cache_clear()  # noqa: SLF001
    for shape, f in feats.items():
        parts = ", ".join(
            f"{name} {times[(name, shape)]:.4f}" for name in libs
        )
        sys.stdout.write(
            f"gram tf32 S={shape[0]} ({shape[1]},{shape[2]}) ms: {parts}; "
            f"torch.bmm TF32 {_library_ms(f):.4f}\n",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
