"""What the timelapse frame path costs the main path's step, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.frame_overhead \\
        [--size 512] [--steps 40] [--rounds 6]

Runs the port's runner on the main path's configuration (seeded VGG19
weights, shipped L-BFGS defaults, ``log_every=10``) with frames off and
with frames into an in-memory sink, modes interleaved round by round,
and prints for each mode:

- the median host interval between consecutive steps (steps 3 on), the
  steady pace of the loop, per round;
- the issuing thread's time in the frame stream's ``submit`` (median,
  and the first frame's, which allocates the pinned pool);
- its pace over the same round's frames-off pace: median, least and
  greatest over the rounds (the host's noise is of the order of the
  frames' cost, so a difference inside that range is not resolved).

The modes: ``save_every=20``; ``save_every=1`` with the stream in
batches of 8 and of 4; and ``save_every=1`` with the frame path cut
short: the device pack only, the pack and the pinned copy without the
worker thread, and the synchronous capture (``async_frames=False``).

Before that, checks of the frame stream against a device kept busy by
``torch.cuda._sleep``: that ``submit`` returns without waiting for the
device, that a thread waiting on a CUDA event lets the main thread run
(the wait releases the GIL), and the issuing thread's µs for each part
of a frame (the device pack, the pinned copy with its event, the whole
``submit``). Then what the host charges for the stream's two costs
beyond those: a frame's copy into fresh memory that a sink keeps
(against memory reused), and a second thread woken every 9 ms, as the
worker is, measured as the issuing thread's rate of small launches
with and without it. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import queue
import statistics
import subprocess
import sys
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationCallbacks,
    OptimizationRunner,
    SilentProgress,
)
from style_transfer_visualizer_tpu_torch.main import prepare_model_and_input
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)

# GPU cycles for ``torch.cuda._sleep``: about 50 ms at 1.98 GHz.
_SLEEP_CYCLES = 100_000_000


def _emit(line: str) -> None:
    sys.stdout.write(line + "\n")


class _ListSink:
    """An in-memory frame sink: keeps every delivered array, or none."""

    def __init__(self, *, keep: bool = True) -> None:
        self.keep = keep
        self.frames: list[np.ndarray] = []

    def append_data(self, frame: np.ndarray) -> None:
        """Keep one frame (or drop it)."""
        if self.keep:
            self.frames.append(frame)

    def close(self) -> None:
        """Nothing to release."""


class _PackOnly:
    """A frame stream that drops the packed frame: the device pack alone."""

    def submit(self, frame: torch.Tensor, deliver) -> None:
        """Drop the frame."""
        del frame, deliver

    def close(self) -> None:
        """Nothing to release."""


class _StageOnly:
    """A frame stream that only copies into pinned buffers: no worker."""

    def __init__(self, pinned) -> None:
        self.pinned = pinned
        self.n = 0

    def submit(self, frame: torch.Tensor, deliver) -> None:
        """The non-blocking copy and its event; nothing is delivered."""
        del deliver
        host, event = self.pinned[self.n]
        self.n += 1
        host.copy_(frame, non_blocking=True)
        event.record()

    def close(self) -> None:
        """Nothing to release."""


class _TimedSubmit:
    """Times each ``submit`` of the stream it wraps."""

    def __init__(self, stream) -> None:
        self.stream = stream
        self.submit_s: list[float] = []

    def submit(self, frame: torch.Tensor, deliver) -> None:
        """Submit, and keep the issuing thread's time for it."""
        t0 = time.perf_counter()
        self.stream.submit(frame, deliver)
        self.submit_s.append(time.perf_counter() - t0)

    def close(self) -> None:
        """Close the wrapped stream."""
        self.stream.close()


def _check_submit(size: int) -> None:
    """submit's host time while the device sleeps; the wait's GIL."""
    frame = torch.zeros((size, size, 3), dtype=torch.uint8, device="cuda")
    # Batches of one: a frame is queued at the next submit.
    stream = AsyncFrameStream(max_queue=2)
    done = threading.Event()
    stream.submit(frame, lambda _f: None)  # allocates the pool
    stream.drain()
    torch.cuda._sleep(_SLEEP_CYCLES)  # noqa: SLF001
    t0 = time.perf_counter()
    stream.submit(frame, lambda _f: done.set())
    # The next submit queues the frame staged before it: the worker then
    # waits on that frame's event.
    stream.submit(frame, lambda _f: None)
    submit_ms = (time.perf_counter() - t0) * 1e3
    # The main thread counts while the worker waits on the event.
    spins = 0
    while not done.is_set():
        spins += 1
    delivered_ms = (time.perf_counter() - t0) * 1e3
    stream.close()
    _emit(
        f"two submits with the device busy: {submit_ms:.3f} ms on the issuing "
        f"thread, delivered after {delivered_ms:.3f} ms; the main thread "
        f"ran {spins} loop turns while the worker waited (0 would mean "
        f"the wait holds the GIL)",
    )


def _breakdown(size: int, reps: int = 50) -> None:
    """Issuing-thread µs of each part of a frame, the device kept busy."""
    x = torch.rand((1, size, size, 3), device="cuda")
    host = torch.empty((size, size, 3), dtype=torch.uint8, pin_memory=True)
    event = torch.cuda.Event(blocking=True)
    frame = image_io.pack_uint8_frame(
        image_io.prepare_image_for_output(x, normalize=True),
    )
    stream = AsyncFrameStream(max_queue=reps)

    def fetch() -> None:
        image_io.pack_uint8_frame(
            image_io.prepare_image_for_output(x, normalize=True),
        )

    def copy_and_record() -> None:
        host.copy_(frame, non_blocking=True)
        event.record()

    def submit() -> None:
        stream.submit(frame, lambda _f: None)

    parts = {"fetch": fetch, "copy+record": copy_and_record, "submit": submit}
    torch.cuda.synchronize()
    for name, fn in parts.items():
        fn()
        torch.cuda._sleep(_SLEEP_CYCLES)  # noqa: SLF001
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        _emit(
            f"issuing thread, {name}: median {statistics.median(times):.1f}"
            f" µs, min {min(times):.1f} over {reps} calls",
        )
    stream.close()


def _launch_rate(wake_every: float | None, seconds: float = 1.0) -> float:
    """Small launches per second from this thread.

    With ``wake_every``, a second thread that does nothing is woken at
    that period, as the frame stream's worker is for each batch.
    """
    x = torch.zeros(16, device="cuda")
    tokens: queue.SimpleQueue = queue.SimpleQueue()

    def idle() -> None:
        while tokens.get() is not None:
            pass

    worker = threading.Thread(target=idle)
    worker.start()
    launches = 0
    start = now = time.perf_counter()
    wake_at = start + (wake_every or seconds)
    while now < start + seconds:
        for _ in range(50):
            x.add_(1)
        launches += 50
        now = time.perf_counter()
        if wake_every is not None and now >= wake_at:
            tokens.put(1)
            wake_at += wake_every
    torch.cuda.synchronize()
    tokens.put(None)
    worker.join()
    return launches / seconds


def _host_costs(size: int, rounds: int = 5, reps: int = 100) -> None:
    """What a thread's wake-up and a kept frame cost this host."""
    pinned = torch.full(
        (size, size, 3), 7, dtype=torch.uint8, pin_memory=True,
    ).numpy()
    reused = np.empty_like(pinned)
    kept: list[np.ndarray] = []
    copies = {
        "into fresh memory that is kept": lambda: kept.append(pinned.copy()),
        "into reused memory": lambda: np.copyto(reused, pinned),
    }
    for name, fn in copies.items():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        _emit(
            f"host, a {size}x{size} frame copied out of a pinned buffer "
            f"{name}: median {statistics.median(times):.1f} µs, min "
            f"{min(times):.1f} over {reps} copies",
        )
    kept.clear()
    modes = {"alone": None, "a thread woken every 9 ms": 0.009}
    rates: dict[str, list[float]] = {name: [] for name in modes}
    _launch_rate(None, 0.3)
    for _ in range(rounds):
        for name, every in modes.items():
            rates[name].append(_launch_rate(every))
    base = statistics.median(rates["alone"])
    for name, runs in rates.items():
        rate = statistics.median(runs)
        _emit(
            f"issuing thread, small launches/s {name}: median {rate:.0f} "
            f"({rate / base:.3f} of alone), rounds "
            + " ".join(f"{v:.0f}" for v in runs),
        )


def _run(content, style, params, steps, save_every, make_stream, keep):
    """One run of the runner: step gaps, the end's tail, submit times.

    ``make_stream`` makes the frame stream for the run; ``None`` with
    ``save_every`` set captures frames synchronously. ``keep`` makes
    the sink keep every frame, as an encoder's list or a GIF does.
    Returns the median and the mean gap between steps (steps 3 on; the
    mean counts every stall, the median none that hit fewer than half
    the steps), the ms from the last step to the run's end (the
    stream's close and the device's), and the submit times.
    """
    config = StyleTransferConfig(
        output=OutputConfig(log_every=10),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True,
        ),
        hardware=HardwareConfig(device="cuda"),
    )
    config.video.save_every = save_every or steps + 1
    bundle, input_img = prepare_model_and_input(
        content, style, config, params=params,
    )
    stream = _TimedSubmit(make_stream()) if make_stream else None
    step_times: list[float] = []
    runner = OptimizationRunner(
        bundle.update_fn, bundle.opt_state, input_img, config,
        progress_bar=SilentProgress(),
        # A step-end callback makes every mode run single steps.
        callbacks=OptimizationCallbacks(
            on_step_end=lambda _m: step_times.append(time.perf_counter()),
        ),
        video_writer=_ListSink(keep=keep) if save_every else None,
        async_frames=stream is not None,
        frame_stream=stream,
    )
    torch.cuda.synchronize()
    runner.run()
    torch.cuda.synchronize()
    tail = (time.perf_counter() - step_times[-1]) * 1e3
    gaps = np.diff(step_times[2:]) * 1e3
    return (
        float(np.median(gaps)), float(np.mean(gaps)), tail,
        stream.submit_s if stream else [],
    )


def _spread(values: list[float]) -> str:
    return (
        f"median {statistics.median(values):.4f} (least {min(values):.4f}, "
        f"greatest {max(values):.4f})"
    )


def main(argv: list[str] | None = None) -> int:
    """Print the card, the stream checks and each mode's step pace."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        msg = "frame_overhead needs a CUDA device"
        raise SystemExit(msg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _emit(f"card: {card}")
    _check_submit(args.size)
    _breakdown(args.size)
    _host_costs(args.size)

    rng = np.random.default_rng(0)
    content, style = (
        rng.uniform(size=(1, args.size, args.size, 3)).astype(np.float32)
        for _ in range(2)
    )
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    pinned = [
        (
            torch.empty(
                (args.size, args.size, 3), dtype=torch.uint8,
                pin_memory=True,
            ),
            torch.cuda.Event(blocking=True),
        )
        for _ in range(args.steps)
    ]
    # The stream queues max_queue // 2 frames at a time.
    modes: dict[str, tuple[int | None, Callable | None, bool]] = {
        "frames off": (None, None, True),
        "save_every=20": (20, AsyncFrameStream, True),
        "save_every=1, batches of 8": (1, lambda: AsyncFrameStream(16), True),
        "save_every=1, batches of 4": (1, lambda: AsyncFrameStream(8), True),
        "save_every=1, batches of 4, frames not kept": (
            1, lambda: AsyncFrameStream(8), False,
        ),
        "save_every=1, device pack only": (1, _PackOnly, True),
        "save_every=1, pack and pinned copy, no worker": (
            1, lambda: _StageOnly(pinned), True,
        ),
        "save_every=1, synchronous capture": (1, None, True),
    }
    # Warm-up: kernel build, first launches.
    _run(content, style, params, 5, 1, AsyncFrameStream, True)
    results: dict[str, list] = {name: [] for name in modes}
    for _ in range(args.rounds):
        for name, (every, make_stream, keep) in modes.items():
            results[name].append(_run(
                content, style, params, args.steps, every, make_stream, keep,
            ))
    for name, runs in results.items():
        submits = [s * 1e3 for r in runs for s in r[3]]
        submit_txt = (
            f"; submit ms median {statistics.median(submits):.3f} (first "
            f"frame {statistics.median(r[3][0] * 1e3 for r in runs):.3f})"
            if submits else ""
        )
        _emit(
            f"{name}: {args.size}x{args.size} {args.steps} steps, per "
            f"round: median gap ms "
            + " ".join(f"{r[0]:.3f}" for r in runs)
            + "; mean gap ms "
            + " ".join(f"{r[1]:.3f}" for r in runs)
            + "; tail ms "
            + " ".join(f"{r[2]:.2f}" for r in runs)
            + submit_txt,
        )
    for i, what in ((0, "median"), (1, "mean")):
        off = [r[i] for r in results["frames off"]]
        for name in list(modes)[1:]:
            ratios = [
                r[i] / b for r, b in zip(results[name], off, strict=True)
            ]
            _emit(
                f"{name} over frames off, {what} gap, per round: "
                f"{_spread(ratios)}",
            )
        ratios = [
            a[i] / b[i] for a, b in zip(
                results["save_every=1, batches of 8"],
                results["save_every=1, batches of 4"],
                strict=True,
            )
        ]
        _emit(
            f"batches of 8 over batches of 4, {what} gap, per round: "
            f"{_spread(ratios)}",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
