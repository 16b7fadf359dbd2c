"""Where a launch of a Gram kernel spends its time, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.gram_parts
    python -m style_transfer_visualizer_tpu_torch.tools.gram_parts --mode ieee

Builds copies of ``csrc/gram.cu`` whose kernel of the chosen mode
leaves out, cumulatively, parts of its work, each into the package's
build directory beside the real library; then times each copy at the
five Gram shapes of the 512x512 main path, alone and at S = 4, beside
``torch.mm`` / ``torch.bmm`` (with TF32 on for ``tf32``, in fp32 for
``ieee``). ``tf32`` (``gram_tf32_kernel``): the two-level sum of the
partial tiles, the products, the transpose of each slab (what is left
streams the slabs through the TMA ring). ``ieee``
(``gram_ieee_kernel``): the two-level sum, then the products (what is
left streams the slabs into shared memory and writes the partial
tile). The copies compute wrong Grams on purpose; nothing but this
tool loads them. Device ms per call from CUDA graphs of 5 calls
replayed twice, the least of two rounds. Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import argparse
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
    (s, p, c) for s in (1, 4)
    for p, c in ((262144, 64), (65536, 128), (16384, 256), (4096, 512),
                 (1024, 512))
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
_IEEE_NO_SUM = [(
    "  sum_partials<true, kIeeeThreads, true>(args, pr, &flag, smem);",
    "  (void)flag;",
)]
_IEEE_NO_FMA = [("  acc = fmaf(a, b, acc);", "  (void)a;\n  (void)b;")]
#: Each variant's edits of the IEEE kernel's text, cumulative.
IEEE_VARIANTS = {
    "whole": [],
    "no sum": _IEEE_NO_SUM,
    "streaming only": _IEEE_NO_SUM + _IEEE_NO_FMA,
}
#: The text each mode's edits apply to: from its kernel to the next part.
_SPANS = {
    "tf32": ("gram_tf32_kernel(const __grid_constant__",
             "// The IEEE fp32 mode on the CUDA cores"),
    "ieee": ("// The IEEE fp32 mode on the CUDA cores",
             "// The last block's write of a pair through shared memory"),
}


def _variant_source(edits: list[tuple[str, str]], mode: str = "tf32") -> str:
    src = (build.CSRC / "gram.cu").read_text()
    first, last = _SPANS[mode]
    start = src.index(first)
    end = src.index(last, start)
    body = src[start:end]
    for old, new in edits:
        if old not in body:
            msg = f"gram_parts: {old!r} is no longer in the {mode} kernel"
            raise RuntimeError(msg)
        body = body.replace(old, new)
    return src[:start] + body + src[end:]


def variants(mode: str) -> dict[str, list[tuple[str, str]]]:
    """``mode``'s variants: its name to its edits."""
    return VARIANTS if mode == "tf32" else IEEE_VARIANTS


def _build_variants(mode: str) -> dict[str, ctypes.CDLL]:
    """One library per variant, built in parallel."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants(mode).items()):
        cu = build.BUILD_DIR / f"gram_parts_{mode}_{i}.cu"
        cu.write_text(_variant_source(edits, mode))
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


def _library_ms(f: torch.Tensor, mode: str) -> float:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        return _graph_ms(partial(torch.bmm, f.mT, f))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def main(argv: list[str] | None = None) -> int:
    """Print the card, then one line per shape: ms per variant."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("tf32", "ieee"), default="tf32")
    mode = parser.parse_args(argv).mode
    if not torch.cuda.is_available():
        msg = "gram_parts needs a CUDA device"
        raise SystemExit(msg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sys.stdout.write(f"card: {card}\n")
    libs = _build_variants(mode)
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
                        float(shape[1] * shape[2]), mode,
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
            f"gram {mode} S={shape[0]} ({shape[1]},{shape[2]}) ms: {parts}; "
            f"torch.bmm {'TF32' if mode == 'tf32' else 'fp32'} "
            f"{_library_ms(f, mode):.4f}\n",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
