"""Peak device memory of graphed runs, whole, rematerialized and banded.

    python -m style_transfer_visualizer_tpu_torch.tools.memory_peaks \\
        [--ceilings | --direction] [--out peaks.json]

The measurement behind the H100 thresholds of ``constants.py``. Each
case runs in a process of its own (a case that runs out of memory ends
its process, not the list): seeded VGG19 weights, seeded content of
the case's size and a 512x512 style, the shipped defaults (``mixed``,
L-BFGS ``max_iter=1``, compact direction, bf16 ring m = 100), targets,
the step built as the entry points build it with the case's ``remat``
and ``tile_rows`` forced (not resolved from the thresholds), then 3
steps in one dispatch (an eager warm-up step, the capture, a replay),
as every run on the card dispatches them. It prints one line per case:
``max_memory_allocated`` and ``max_memory_reserved`` of the process
(everything the run holds: weights, targets, the L-BFGS ring, the
step's activations), the bytes held before the steps (weights, images,
targets, optimizer state), the seconds, or ``OOM``. The batch cases are the
multi-style batch at 512x512, S styles, likewise. Then the card's
total memory (``torch.cuda.mem_get_info``) and a line fitted through
the whole and remat peaks: bytes = a + b x pixels. ``--ceilings`` runs
larger sizes instead, whole and rematerialized, and 8K UHD in 2 bands,
to find where each stops fitting. ``--direction`` times the L-BFGS
compact direction (``engine.optimizers._compact_direction``) at
2048x2048, 3840x2160 and 4096x4096 on the card's path (the two kernels
of ``csrc/lbfgs_ring.cu``, which read the bf16 ring as stored), and on
the plain path (a CPU run's, or an fp32 ring's) with its ring upcast in
blocks of ``ops.lbfgs_ring.UPCAST_COLUMNS`` columns and in one block,
with the peak of each.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.config import OptimizationConfig
from style_transfer_visualizer_tpu_torch.engine import optimizers
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    init_random_params,
)
from style_transfer_visualizer_tpu_torch.ops import lbfgs_ring
from style_transfer_visualizer_tpu_torch.ops.precision import (
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.ops.tiled import (
    compute_tiled_targets,
)
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
    initialize_multi_inputs,
    multi_style_targets,
)

#: (kind, height, width, remat, tile_rows, styles)
CASES = (
    ("single", 2048, 2048, False, 0, 1),
    ("single", 2160, 3840, False, 0, 1),
    ("single", 4096, 4096, False, 0, 1),
    ("single", 4320, 7680, False, 0, 1),
    ("single", 2048, 2048, True, 0, 1),
    ("single", 2160, 3840, True, 0, 1),
    ("single", 4096, 4096, True, 0, 1),
    ("single", 4320, 7680, True, 0, 1),
    ("single", 2160, 3840, False, 720, 1),
    ("single", 4096, 4096, False, 1024, 1),
    ("single", 4320, 7680, False, 864, 1),
    ("single", 4320, 7680, False, 1440, 1),
    ("batch", 512, 512, False, 0, 4),
    ("batch", 512, 512, False, 0, 8),
    ("batch", 512, 512, True, 0, 4),
    ("batch", 512, 512, True, 0, 8),
    ("batch", 1024, 1024, False, 0, 16),
    ("batch", 1024, 1024, True, 0, 16),
)
#: ``--ceilings``: whole and remat past 4096x4096, and 8K in 2 bands,
#: to find where each stops fitting.
CEILING_CASES = (
    ("single", 4608, 4608, False, 0, 1),
    ("single", 4864, 4864, False, 0, 1),
    ("single", 5120, 5120, False, 0, 1),
    ("single", 4864, 4864, True, 0, 1),
    ("single", 5120, 5120, True, 0, 1),
    ("single", 5376, 5376, True, 0, 1),
    ("single", 4320, 7680, False, 2160, 1),
)
STEPS = 3
STYLE_SIDE = 512


def _say(line: str, stream=None) -> None:
    (stream or sys.stdout).write(line + "\n")


def _arrays(height: int, width: int, styles: int):
    rng = np.random.default_rng(0)
    content = rng.uniform(size=(1, height, width, 3)).astype(np.float32)
    style_list = [
        rng.uniform(size=(1, STYLE_SIDE, STYLE_SIDE, 3)).astype(np.float32)
        for _ in range(styles)
    ]
    return content, style_list


def run_case(case: tuple) -> dict:
    """Run one case in this process; its peaks and seconds."""
    kind, height, width, remat, tile_rows, styles = case
    device = torch.device("cuda")
    opt = OptimizationConfig(allow_random_weights=True)
    precision = resolve_precision("mixed")
    content, style_list = _arrays(height, width, styles)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_random_params(0, device)
    content_img = image_io.host_array_to_device(content, device)
    style_imgs = [
        image_io.host_array_to_device(s, device) for s in style_list
    ]
    del content, style_list
    shape = tuple(content_img.shape)
    common = {
        "optimizer": opt.optimizer, "lr": opt.lr, "style_w": opt.style_w,
        "content_w": opt.content_w,
        "style_layers": tuple(opt.style_layers),
        "content_layers": tuple(opt.content_layers),
        "lbfgs_history_size": opt.lbfgs_history_size,
        "lbfgs_history_dtype": opt.lbfgs_history_dtype,
        "lbfgs_direction": opt.lbfgs_direction,
        "precision": precision, "remat": remat,
    }
    if kind == "single":
        targets = (
            compute_tiled_targets(
                params, style_imgs[0], content_img, common["style_layers"],
                common["content_layers"], tile_rows_content=tile_rows,
                precision=precision,
            ) if tile_rows else compute_targets(
                params, style_imgs[0], content_img, common["style_layers"],
                common["content_layers"], precision,
            )
        )
        bundle = build_update_step(
            params, targets, shape, tile_rows=tile_rows, **common,
        )
        image = content_img.clone()
    else:
        targets = multi_style_targets(
            params, content_img, style_imgs, common["style_layers"],
            common["content_layers"], precision,
        )
        bundle = build_multi_style_update(
            params, targets, shape, styles, **common,
        )
        image = initialize_multi_inputs(
            content_img, "content", None, styles,
        )
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    _, _, aux = bundle.chunked_update_fn(image, bundle.opt_state, STEPS)
    losses = aux.loss.double().cpu().numpy().tolist()
    torch.cuda.synchronize()
    return {
        "case": list(case),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "held_before_steps": held,
        "seconds": round(time.perf_counter() - t0, 3),
        "finite": bool(np.isfinite(np.asarray(losses)).all()),
    }


#: ``--direction``: image sides whose L-BFGS direction is timed.
DIRECTION_SIZES = ((2048, 2048), (2160, 3840), (4096, 4096))


def _plain_direction(grad, state):
    """The compact direction on the plain path (the ring upcast in
    ``lbfgs_ring.UPCAST_COLUMNS`` blocks), as a CPU run or an fp32 ring
    takes it."""
    coeff = optimizers._compact_coefficients(  # noqa: SLF001
        lbfgs_ring.products_plain(state.s_hist, state.y_hist, grad), state,
    )
    return lbfgs_ring.combine_plain(
        state.s_hist, state.y_hist, grad, *coeff, state.h_diag,
    )


def _direction_line(height: int, width: int) -> str:
    """The compact direction's device ms and peak at one image size:
    the card's path (the two kernels of ``csrc/lbfgs_ring.cu``), then
    the plain path with the ring upcast in ``UPCAST_COLUMNS`` blocks
    and in one block."""
    n = 3 * height * width
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    state = optimizers.lbfgs_init(n, 100, device, torch.bfloat16)
    state.s_hist.copy_(torch.randn(state.s_hist.shape, generator=gen,
                                   device=device))
    state.y_hist.copy_(state.s_hist + 0.1 * torch.randn(
        state.y_hist.shape, generator=gen, device=device,
    ))
    state.hist_len.fill_(100)
    state.h_diag.fill_(0.5)
    grad = torch.randn((n,), generator=gen, device=device)

    def card():
        return optimizers._compact_direction(grad, state)  # noqa: SLF001

    def plain():
        return _plain_direction(grad, state)

    out = []
    default = lbfgs_ring.UPCAST_COLUMNS
    for fn, columns in ((card, default), (plain, default), (plain, n)):
        lbfgs_ring.UPCAST_COLUMNS = columns
        direction = fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            direction = fn()
        end.record()
        torch.cuda.synchronize()
        out.append((
            start.elapsed_time(end) / 5,
            torch.cuda.max_memory_allocated() - before, direction,
        ))
    lbfgs_ring.UPCAST_COLUMNS = default
    (ms_k, peak_k, d_k), (ms_b, peak_b, d_b), (ms_1, peak_1, d_1) = out
    diff = float((d_b - d_1).abs().max() / d_1.abs().max())
    diff_k = float((d_k - d_b).norm() / d_b.norm())
    blocks = -(-n // default)
    return (
        f"direction {width}x{height} (n {n}, m 100, bf16 ring): "
        f"kernels {ms_k:.3f} ms, peak above the ring {peak_k}; plain "
        f"{blocks} blocks of {default} columns {ms_b:.3f} ms, peak "
        f"{peak_b}; one block {ms_1:.3f} ms, peak {peak_1}; largest "
        f"difference over the largest magnitude, blocks against one "
        f"{diff:.3g}; kernels against blocks, norm of the difference "
        f"over the norm {diff_k:.3g}"
    )


def _child(case: tuple) -> dict:
    """Run ``case`` in a process of its own; its result or its OOM."""
    proc = subprocess.run(  # noqa: S603 - this interpreter, this module
        [sys.executable, "-m", __spec__.name, "--case", json.dumps(case)],
        capture_output=True, text=True, check=False,
    )
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    oom = "OutOfMemoryError" in proc.stderr
    return {
        "case": list(case), "oom": oom, "returncode": proc.returncode,
        "stderr_tail": proc.stderr[-600:],
    }


def _fit(points: list[tuple[int, int]]) -> tuple[float, float] | None:
    """``(a, b)`` of bytes = a + b x pixels through the first and last
    points, or None with fewer than two."""
    if len(points) < 2:  # noqa: PLR2004
        return None
    (p0, m0), (p1, m1) = points[0], points[-1]
    b = (m1 - m0) / (p1 - p0)
    return m0 - b * p0, b


def main(argv: list[str] | None = None) -> int:
    """Run every case (or ``--case`` alone) and print the results."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--case", help="one case as JSON (internal)")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument(
        "--ceilings", action="store_true",
        help="run CEILING_CASES instead of CASES",
    )
    parser.add_argument(
        "--direction", action="store_true",
        help="time the L-BFGS direction: kernels, plain in blocks, whole",
    )
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        _say("memory_peaks needs a CUDA device", sys.stderr)
        return 2
    if args.case:
        _say(json.dumps(run_case(tuple(json.loads(args.case)))))
        return 0
    if args.direction:
        for height, width in DIRECTION_SIZES:
            _say(_direction_line(height, width))
            torch.cuda.empty_cache()
        return 0
    free, total = torch.cuda.mem_get_info()
    card = subprocess.run(  # noqa: S603
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    _say(f"card {card}: mem_get_info total {total} free {free}")
    results = []
    for case in CEILING_CASES if args.ceilings else CASES:
        res = _child(case)
        results.append(res)
        kind, h, w, remat, tile_rows, styles = case
        label = (
            f"{kind} {w}x{h} ({h * w} px) styles {styles} remat {remat} "
            f"tile_rows {tile_rows}"
        )
        if "max_memory_allocated" in res:
            _say(
                f"{label}: max_memory_allocated "
                f"{res['max_memory_allocated']} max_memory_reserved "
                f"{res['max_memory_reserved']} held before the steps "
                f"{res['held_before_steps']} seconds {res['seconds']} "
                f"finite {res['finite']}",
            )
        else:
            _say(
                f"{label}: {'OOM' if res['oom'] else 'FAILED'} (rc "
                f"{res['returncode']}) {res['stderr_tail'][-300:]!r}",
            )
    for remat in (False, True):
        points = sorted(
            (r["case"][1] * r["case"][2], r["max_memory_allocated"])
            for r in results
            if "max_memory_allocated" in r and r["case"][0] == "single"
            and r["case"][3] == remat and not r["case"][4]
        )
        fit = _fit(points)
        if fit is not None:
            a, b = fit
            _say(
                f"single whole remat {remat}: bytes = {a:.0f} + {b:.2f} x "
                f"px over {points}; the card's total is reached at "
                f"{(total - a) / b:.0f} px",
            )
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "total": total, "results": results}, indent=1,
        ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
