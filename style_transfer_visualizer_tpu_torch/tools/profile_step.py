"""Where one optimizer step spends its time, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.profile_step \\
        [--size 512] [--steps 5] [--model vgg19] [--optimizer lbfgs] \\
        [--objective] [--styles S] [--precision mixed] [--out DIR]

Builds the step as ``main.run_style_transfer`` does (seeded weights of
``--model``, shipped defaults, ``--optimizer``; ``--objective`` adds
``chip_smoke.py``'s objective terms: TV 1e-2, Laplacian 1e2 at pool 4,
style weights 1,1,0.5,0.25,0.25), or with ``--styles S`` the
multi-style batch's stacked step of S styles as
``main.prepare_multi_style`` builds it, at the ``--precision`` tier
(``ops/precision.py``; ``mixed`` by default); runs 3 warm-up steps, then times
``--steps`` steps with CUDA events, split into the VGG loss-and-gradient
evaluation and (for L-BFGS) the direction, and traces them with
``torch.profiler``: the eager step (``update_fn``, hundreds of launches
from the host) and the graphed step (one replay of the CUDA graph of
``chunked_update_fn``, as every run dispatches it; its capture is
timed first). For each it prints the times, the device-busy share of
the traced window and of the untraced step, each ``csrc/`` kernel's
launches and share of device time (the kernels inside a replay show
in the device time), and the operators by device time, and writes the
Chrome traces under ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
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
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.models.features import (
    batched_total_loss,
    compute_targets,
    initialize_input,
    total_loss,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    init_random_params,
)
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.ops.precision import (
    PRECISION_NAMES,
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
    initialize_multi_inputs,
    multi_style_targets,
)


# Device kernels of csrc/ (every mode), listed by name whatever their rank.
_PORT_KERNELS = (
    "conv3x3_tc_kernel", "conv3x3_ieee_kernel", "gram_tc_kernel",
    "gram_ieee_kernel",
)


def _emit(line: str) -> None:
    sys.stdout.write(line + "\n")


def _peak_and_reset() -> int:
    """Peak allocated device bytes since the last reset; then reset."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> int:
    """Profile the main path's step; return the exit code."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--model", default="vgg19", choices=("vgg19", "vgg16"))
    p.add_argument(
        "--optimizer", default="lbfgs", choices=("lbfgs", "adam"),
    )
    p.add_argument(
        "--objective", action="store_true",
        help="add the TV and Laplacian terms and per-layer style weights",
    )
    p.add_argument(
        "--styles", type=int, default=0,
        help="profile the multi-style batch's step of this many styles",
    )
    p.add_argument("--precision", default="mixed", choices=PRECISION_NAMES)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    precision = resolve_precision(args.precision)
    if not torch.cuda.is_available():
        msg = "profile_step needs a CUDA device"
        raise SystemExit(msg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _emit(f"card: {card}")

    dev = torch.device("cuda")
    terms = {
        "tv_w": 1e-2, "lap_w": 1e2,
        "style_layer_weights": [1, 1, 0.5, 0.25, 0.25],
    } if args.objective else {}
    opt = OptimizationConfig(
        model=args.model, optimizer=args.optimizer, **terms,
    )
    rng = np.random.default_rng(0)
    content, style, *more = (
        image_io.host_array_to_device(
            rng.uniform(size=(1, args.size, args.size, 3)).astype(
                np.float32,
            ),
            dev, normalize=True,
        )
        for _ in range(max(2, args.styles + 1))
    )
    # Peak device memory of each phase of the main path, in order.
    peaks: dict[str, int] = {}
    torch.cuda.reset_peak_memory_stats()
    params = init_random_params(
        opt.seed, dev, get_architecture(opt.model),
    )
    packed = sum(
        t.numel() * t.element_size()
        for layer in params.values() for k, t in layer.items()
        if k.startswith("wk")
    )
    _emit(
        f"weights on the card: {torch.cuda.memory_allocated()} bytes, of "
        f"which the packed tf32 stencils {packed}",
    )
    peaks["weights"] = _peak_and_reset()
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)
    batch = args.styles
    if batch:
        styles = [style, *more][:batch]
        targets = multi_style_targets(
            params, content, styles, style_layers, content_layers, precision,
        )
    else:
        targets = compute_targets(
            params, style, content, style_layers, content_layers, precision,
        )
    peaks["targets"] = _peak_and_reset()
    step_args = {
        "optimizer": opt.optimizer, "lr": opt.lr, "style_w": opt.style_w,
        "content_w": opt.content_w, "tv_w": opt.tv_w, "lap_w": opt.lap_w,
        "lap_pool": opt.lap_pool,
        "lap_target": (
            lap_response(content, opt.lap_pool) if opt.lap_w else None
        ),
        "style_layers": style_layers, "content_layers": content_layers,
        "style_weights": opt.style_weights_tuple(),
        "lbfgs_history_size": opt.lbfgs_history_size,
        "lbfgs_history_dtype": opt.lbfgs_history_dtype,
        "lbfgs_direction": opt.lbfgs_direction,
        "precision": precision,
    }
    gen = torch.Generator(device=dev).manual_seed(opt.seed)
    if batch:
        bundle = build_multi_style_update(
            params, targets, tuple(content.shape), batch, **step_args,
        )
        image = initialize_multi_inputs(
            content, opt.init_method, gen, batch,
        )
    else:
        bundle = build_update_step(
            params, targets, tuple(content.shape), **step_args,
        )
        image = initialize_input(content, opt.init_method, gen)
    state = bundle.opt_state
    peaks["optimizer set-up"] = _peak_and_reset()
    for i in range(3):
        image, state, _ = bundle.update_fn(image, state)
        if i == 0:
            peaks["first step"] = _peak_and_reset()
    peaks["steps 2-3"] = _peak_and_reset()
    _emit(
        "max_memory_allocated by phase: "
        + ", ".join(f"{k} {v}" for k, v in peaks.items()),
    )

    holder = {"image": image, "state": state}

    def step():
        holder["image"], holder["state"], _ = bundle.update_fn(
            holder["image"], holder["state"],
        )

    def loss_and_grad():
        x = holder["image"].detach().requires_grad_(True)
        if batch:
            total, _ = batched_total_loss(
                params, x.reshape(-1, *x.shape[2:]), targets, opt.style_w,
                opt.content_w, style_layers, content_layers,
                opt.style_weights_tuple(), precision,
            )
            total = total.sum()
        else:
            total, _ = total_loss(
                params, x, targets, opt.style_w, opt.content_w,
                style_layers, content_layers, opt.style_weights_tuple(),
                precision,
            )
        torch.autograd.grad(total, x)

    grad = torch.randn((max(batch, 1), image.numel() // max(batch, 1)),
                       device=dev)

    def direction():
        # The batch runs the single direction once per style.
        for i, g in enumerate(grad):
            optimizers._compact_direction(  # noqa: SLF001
                g,
                optimizers._style(holder["state"], i)  # noqa: SLF001
                if batch else holder["state"],
            )

    def graphed():
        holder["image"], holder["state"], _ = bundle.chunked_update_fn(
            holder["image"], holder["state"], 1,
        )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed()
    torch.cuda.synchronize()
    _emit(
        f"graphed step: first dispatch (one eager step, then the capture) "
        f"{time.perf_counter() - t0:.4f} s, of which the capture "
        f"{bundle.chunked_update_fn.capture_seconds[-1]:.4f} s; "
        f"max_memory_allocated with the graph {_peak_and_reset()}",
    )
    label = (
        f"{args.size}x{args.size} {opt.model} {opt.optimizer}"
        f"{' objective' if args.objective else ''}"
        f"{f' batch of {batch} styles' if batch else ''}"
    )
    vag_ms = _event_ms(loss_and_grad, args.steps)
    dir_ms = (
        f"{_event_ms(direction, args.steps):.3f}"
        if opt.optimizer == "lbfgs" else "none"
    )
    _emit(
        f"{label}: vgg loss_and_grad_ms {vag_ms:.3f}, compact_direction_ms "
        f"{dir_ms}",
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for mode, fn in (("eager", step), ("graphed", graphed)):
        _profile(f"{label} {mode}", fn, args.steps, out / f"{mode}.json")
    return 0


def _profile(label: str, fn, steps: int, trace: Path) -> None:
    """Time ``steps`` calls of ``fn`` (one step each), then trace them."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_ms = _event_ms(fn, steps)
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    _emit(
        f"{label}: step_ms {step_ms:.3f} (host clock {host_ms:.3f}), "
        f"max_memory_allocated over the steps {peak}",
    )
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(trace))
    events = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    # The profiler slows the host, so the traced window's busy share is
    # low whenever the host issues slower than the device runs; the
    # device time per step over the untraced step time is the share
    # without the profiler.
    busy_ms_step = busy_us / steps / 1e3
    _emit(
        f"{label}: traced {steps} steps: wall_ms {wall_us / 1e3:.3f}, "
        f"device kernel time ms {busy_us / 1e3:.3f}, device busy share "
        f"{busy_us / max(wall_us, 1e-9):.3f} traced, "
        f"{busy_ms_step / step_ms:.3f} of the untraced step "
        f"({busy_ms_step:.3f} ms/step)",
    )
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
            k in e.key for k in _PORT_KERNELS
        ):
            _emit(
                f"{label}: port kernel {e.key[:60]}: "
                f"{e.count / steps:g} launches/step, "
                f"{e.self_device_time_total / 1e3:.3f} ms, share "
                f"{e.self_device_time_total / max(busy_us, 1e-9):.4f}",
            )
    _emit(events.table(
        sort_by="self_device_time_total", row_limit=25,
        max_name_column_width=60,
    ))


if __name__ == "__main__":
    raise SystemExit(main())
