"""Where one L-BFGS step of the main path spends its time, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.profile_step \\
        [--size 512] [--steps 5] [--out chiprun_out/profile]

Builds the main path as ``main.run_style_transfer`` does (seeded VGG19
weights, shipped defaults), runs 3 warm-up steps, then times ``--steps``
steps with CUDA events, split into the loss-and-gradient evaluation
and the L-BFGS direction, and traces them with ``torch.profiler``. It
prints the card, the times, the device-busy share of the traced window,
each ``csrc/`` kernel's launches and share of device time, and the
operators by device time, and writes the Chrome trace under
``--out``. Needs a CUDA device.
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
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
    initialize_input,
    total_loss,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    init_random_params,
)


# Device kernels of csrc/, listed by name whatever their rank.
_PORT_KERNELS = (
    "conv3x3_kernel", "gram_partial_kernel", "gram_reduce_kernel",
)


def _emit(line: str) -> None:
    sys.stdout.write(line + "\n")


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
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
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
    opt = OptimizationConfig()
    rng = np.random.default_rng(0)
    content, style = (
        image_io.host_array_to_device(
            rng.uniform(size=(1, args.size, args.size, 3)).astype(
                np.float32,
            ),
            dev, normalize=True,
        )
        for _ in range(2)
    )
    params = init_random_params(opt.seed, dev)
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)
    targets = compute_targets(
        params, style, content, style_layers, content_layers,
    )
    bundle = build_update_step(
        params, targets, tuple(content.shape), lr=opt.lr,
        style_w=opt.style_w, content_w=opt.content_w,
        style_layers=style_layers, content_layers=content_layers,
        lbfgs_history_size=opt.lbfgs_history_size,
        lbfgs_history_dtype=opt.lbfgs_history_dtype,
        lbfgs_direction=opt.lbfgs_direction,
    )
    gen = torch.Generator(device=dev).manual_seed(opt.seed)
    image = initialize_input(content, opt.init_method, gen)
    state = bundle.opt_state
    for _ in range(3):
        image, state, _ = bundle.update_fn(image, state)
    torch.cuda.synchronize()

    holder = {"image": image, "state": state}

    def step():
        holder["image"], holder["state"], _ = bundle.update_fn(
            holder["image"], holder["state"],
        )

    def loss_and_grad():
        x = holder["image"].detach().requires_grad_(True)
        total, _ = total_loss(
            params, x, targets, opt.style_w, opt.content_w,
            style_layers, content_layers,
        )
        torch.autograd.grad(total, x)

    grad = torch.randn(image.numel(), device=dev)

    def direction():
        optimizers._compact_direction(grad, holder["state"])  # noqa: SLF001

    t0 = time.perf_counter()
    step_ms = _event_ms(step, args.steps)
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3
    vag_ms = _event_ms(loss_and_grad, args.steps)
    dir_ms = _event_ms(direction, args.steps)
    _emit(
        f"{args.size}x{args.size}: step_ms {step_ms:.3f} (host clock "
        f"{host_ms:.3f}), loss_and_grad_ms {vag_ms:.3f}, "
        f"compact_direction_ms {dir_ms:.3f}",
    )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(out / "step_trace.json"))
    events = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    _emit(
        f"traced {args.steps} steps: wall_ms {wall_us / 1e3:.3f}, "
        f"device kernel time ms {busy_us / 1e3:.3f}, device busy share "
        f"{busy_us / wall_us:.3f}",
    )
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
            k in e.key for k in _PORT_KERNELS
        ):
            _emit(
                f"port kernel {e.key[:60]}: {e.count / args.steps:g} "
                f"launches/step, {e.self_device_time_total / 1e3:.3f} ms, "
                f"share {e.self_device_time_total / busy_us:.4f}",
            )
    _emit(events.table(
        sort_by="self_device_time_total", row_limit=25,
        max_name_column_width=60,
    ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
