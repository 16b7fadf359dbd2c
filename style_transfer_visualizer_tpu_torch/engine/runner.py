"""Optimization loop orchestration: dispatch, metrics, frames, callbacks.

The port of the JAX package's ``engine/runner.py``. PyTorch queues each
step's kernels on the device's stream and returns; the host waits for
the device only at the ``log_every`` loss reads (and at the end), so
steps pipeline back to back. Timelapse frames are packed to uint8 on
the device and reach the sinks through ``media.stream.AsyncFrameStream``
(pinned buffers, events, a worker thread), so a frame never stalls
dispatch either.

Behavioral contracts kept from the JAX package:
- metrics, frames and callbacks fire once per *accepted* step, however
  many function evaluations L-BFGS used;
- steps run in chunks that divide every per-step cadence (CSV rows,
  frames, checkpoints), so frames land exactly on the ``save_every``
  grid; ``hardware.steps_per_dispatch`` tunes the chunk as in the JAX
  package (1 is single steps). Every dispatch, a single step too, goes
  through ``chunked_update_fn`` when there is one: on the card that is
  ``engine.step.GraphedChunk``, CUDA-graph replays of the step;
- the one-shot intro crossfade precedes the first saved stylized frame;
- closure-evaluation telemetry is reported at the end of the run;
- non-finite losses produce warnings, at the sync cadence;
- the loss history is a device ring of ``min(steps, 2048)`` rows,
  exported at the end, and is ``{}`` when the CSV owns the series; a
  CSV that cannot be opened degrades to the ring via the error callback;
- a run can start at ``start_step`` (a resumed checkpoint): the
  progress bar starts there and the loss CSV is appended to;
- a checkpoint is saved after the frame at every ``checkpoint_every``
  step when a ``checkpoint_path`` is given (one host read per save);
- every resource is closed even when one fails (``_cleanup``).

On a mesh (``parallel.mesh.Mesh``, a row-sharded run) every rank runs
the loop on its rows; rank 0 alone writes the CSV, the frames and the
checkpoints. The frames, the checkpoints and the returned image gather
the rows on every rank at the same steps (a gather is a collective),
and the losses, replicated, are read on every rank alike.
"""
from __future__ import annotations

import math
import sys
import time
from collections.abc import Callable, Mapping
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Protocol

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.constants import (
    CSV_LOGGING_RECOMMENDED_STEPS,
)
from style_transfer_visualizer_tpu_torch.engine.loss_accumulator import (
    DEFAULT_HISTORY_CAPACITY,
    LoggedLoss,
    LossAccumulator,
)
from style_transfer_visualizer_tpu_torch.engine.loss_logger import (
    LossCSVLogger,
)
from style_transfer_visualizer_tpu_torch.media.segments import (
    append_crossfade,
)
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream
from style_transfer_visualizer_tpu_torch.ops.color import (
    maybe_restore_color,
    yiq_matrices,
)
from style_transfer_visualizer_tpu_torch.parallel.spatial import (
    gather_state,
)
from style_transfer_visualizer_tpu_torch.runtime.checkpoint import (
    save_checkpoint,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu_torch.utils.trace import span, spanned

# Upper bound on steps per chunk (the progress granularity).
_MAX_CHUNK = 50
# Chunk used when no cadence constrains alignment.
DEFAULT_CHUNK = 25


def aligned_chunk(cadences: list[int]) -> int:
    """Largest dispatch chunk that divides every per-step cadence.

    gcd of the cadences, capped by shrinking *along divisors*: a plain
    min() cap would break the divides-every-cadence invariant (gcd 60
    capped to 50 skips every 60-step CSV row). No cadences means nothing
    constrains alignment: use the default chunk.
    """
    if not cadences:
        return DEFAULT_CHUNK
    chunk = math.gcd(*cadences)
    if chunk > _MAX_CHUNK:
        chunk = max(
            d for d in range(1, _MAX_CHUNK + 1) if chunk % d == 0
        )
    return max(1, chunk)


def dispatch_chunk(requested: int, cadences: list[int]) -> int:
    """The chunk for ``hardware.steps_per_dispatch`` = ``requested``.

    1 means single steps; any other value folds into the gcd of the
    cadences (0 adds nothing), so it tunes but never breaks alignment.
    """
    if requested == 1:
        return 1
    return aligned_chunk([*cadences, requested] if requested else cadences)


if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import (
        StyleTransferConfig,
    )
    from style_transfer_visualizer_tpu_torch.engine.optimizers import (
        StepAux,
    )
    from style_transfer_visualizer_tpu_torch.engine.step import (
        OptState,
        UpdateFn,
    )
    from style_transfer_visualizer_tpu_torch.media.sinks import (
        VideoFrameSink,
    )
    from style_transfer_visualizer_tpu_torch.type_defs import LossHistory


class ProgressReporter(Protocol):
    """The slice of tqdm's interface the runner relies on."""

    def update(self, n: float | None = 1) -> bool | None:
        """Advance the display."""

    def set_postfix(
        self,
        ordered_dict: Mapping[str, object] | None = None,
        refresh: bool | None = True,
        **kwargs: object,
    ) -> None:
        """Show supplementary values."""

    def close(self) -> None:
        """Release display resources."""


class SilentProgress:
    """A progress reporter that shows nothing."""

    def update(self, n: float | None = 1) -> bool | None:
        """Ignore an advance."""
        del n
        return None

    def set_postfix(
        self,
        ordered_dict: Mapping[str, object] | None = None,
        refresh: bool | None = True,
        **kwargs: object,
    ) -> None:
        """Ignore supplementary values."""
        del ordered_dict, refresh, kwargs

    def close(self) -> None:
        """Nothing to release."""


def default_progress(
    total: int, initial: int, desc: str = "Style Transfer",
) -> ProgressReporter:
    """A tqdm bar, or a silent reporter where tqdm is not installed."""
    try:
        from tqdm import tqdm  # noqa: PLC0415 - optional dependency
    except ImportError:
        logger.info("tqdm not installed: no progress bar.")
        return SilentProgress()
    return tqdm(total=total, initial=initial, desc=desc)


@dataclass(slots=True)
class StepMetrics:
    """Host-synced scalars surfaced to callbacks (may be empty off-cadence)."""

    step: int
    style_loss: float | None = None
    content_loss: float | None = None
    total_loss: float | None = None

    @property
    def has_values(self) -> bool:
        """True when all three loss values are populated."""
        return (
            self.style_loss is not None
            and self.content_loss is not None
            and self.total_loss is not None
        )


@dataclass(slots=True)
class OptimizationCallbacks:
    """Optional hooks around optimization events."""

    on_step_start: Callable[[int], None] | None = None
    on_step_end: Callable[[StepMetrics], None] | None = None
    on_video_frame: Callable[[np.ndarray, int], None] | None = None
    on_logging_error: Callable[[Exception], None] | None = None


class OptimizationRunner:
    """Run the update loop with logging, frames, and callbacks."""

    def __init__(
        self,
        update_fn: UpdateFn,
        opt_state: OptState,
        input_img: torch.Tensor,
        config: StyleTransferConfig,
        *,
        progress_bar: ProgressReporter | None = None,
        callbacks: OptimizationCallbacks | None = None,
        video_writer: VideoFrameSink | None = None,
        gif_collector: VideoFrameSink | None = None,
        intro_last_frame: np.ndarray | None = None,
        intro_crossfade_frames: int = 0,
        async_frames: bool = True,
        frame_stream: AsyncFrameStream | None = None,
        chunked_update_fn: Callable | None = None,
        chroma_source: torch.Tensor | None = None,
        start_step: int = 0,
        checkpoint_path: Path | None = None,
        mesh=None,
    ) -> None:
        """Set up the loop; nothing runs until :meth:`run`.

        ``frame_stream`` carries frames to the sinks when
        ``async_frames`` is on (by default one is made at the first
        frame); the runner closes it at the end of the run.
        ``chroma_source`` (the content image, (1, H, W, 3) in [0,1] on
        the run's device) recolors every frame by luminance transfer
        on the device before the pack. The loop runs steps ``start_step
        + 1`` to ``steps``; ``checkpoint_path`` receives a checkpoint at
        every ``output.checkpoint_every`` step (none without a path).
        ``mesh`` makes ``input_img`` and ``opt_state`` this rank's rows
        of a row-sharded run; rank 0 then holds the sinks and the path.
        """
        self.update_fn = update_fn
        self.chunked_update_fn = chunked_update_fn
        self.opt_state = opt_state
        self.input_img = input_img
        self.config = config

        self._progress_bar = progress_bar
        self._owns_progress_bar = False
        self.callbacks = callbacks or OptimizationCallbacks()

        self.video_writer = video_writer
        self.gif_collector = gif_collector
        self.intro_last_frame = intro_last_frame
        self.intro_crossfade_frames = intro_crossfade_frames
        self.intro_transition_done = intro_last_frame is None

        self._async_frames = async_frames
        self._frame_stream = frame_stream
        self._chroma_source = chroma_source
        if chroma_source is not None:
            # The YIQ matrices go to the device now: made at the first
            # frame, their copy would wait for the step's stream.
            yiq_matrices(chroma_source.device)

        self._step_index = start_step
        self._start_step = start_step
        self._checkpoint_path = checkpoint_path
        self._mesh = mesh
        self._writes = mesh is None or mesh.writes

        self.loss_logger: LossCSVLogger | None = None
        self._accumulator: LossAccumulator | None = None
        self._latest_logged: LoggedLoss | None = None
        self._configure_logging()
        self._frames_on = video_writer is not None or gif_collector is not None
        self._csv_on = self.loss_logger is not None
        if mesh is not None:
            # Every rank takes rank 0's frame and chunk decisions.
            self._frames_on, self._csv_on = mesh.any(
                self._frames_on, self._csv_on,
            )
        # Running device-side eval counter, read once at the end.
        self._eval_total: torch.Tensor | int = 0

    @property
    def progress_bar(self) -> ProgressReporter:
        """The active progress reporter (run() must have started)."""
        if self._progress_bar is None:
            msg = "Progress bar not initialized. Call run() before use."
            raise RuntimeError(msg)
        return self._progress_bar

    @property
    def total_steps(self) -> int:
        """Configured step count."""
        return self.config.optimization.steps

    @property
    def latest_logged(self) -> LoggedLoss | None:
        """Most recent host-synced loss row (None before first cadence)."""
        return self._latest_logged

    @spanned("stv.loop")
    def run(self) -> tuple[torch.Tensor, LossHistory, float]:
        """Execute the loop; return (image, loss history, elapsed seconds)."""
        if self._progress_bar is None:
            self._progress_bar = default_progress(
                self.total_steps, self._start_step,
            )
            self._owns_progress_bar = True

        chunk = self._resolve_chunk_size()
        start_time = time.perf_counter()
        try:
            while self._step_index < self.total_steps:
                step_idx = self._step_index + 1
                remaining = self.total_steps - self._step_index
                # Chunks only while their ends stay on the cadence grid:
                # a resumed run may start off it, and runs single steps
                # until it is back on.
                if (
                    chunk > 1
                    and remaining >= chunk
                    and self._step_index % chunk == 0
                ):
                    self.input_img, self.opt_state, auxes = (
                        self.chunked_update_fn(
                            self.input_img, self.opt_state, chunk,
                        )
                    )
                    self._finalize_chunk(step_idx, chunk, auxes)
                    continue

                if self.callbacks.on_step_start is not None:
                    self.callbacks.on_step_start(step_idx)

                self.input_img, self.opt_state, aux = self._one_step()
                self._finalize_step(step_idx, aux)
        finally:
            self._cleanup()

        with span("stv.loop.final"):
            if self.input_img.is_cuda:
                torch.cuda.synchronize(self.input_img.device)
            elapsed = time.perf_counter() - start_time
            self._log_summary()

            history: LossHistory
            if (
                self._accumulator is not None
                and self._accumulator.tracks_history
            ):
                history = self._accumulator.export_history()
            else:
                history = {}
            return self._whole(self.input_img), history, elapsed

    # ------------------------------------------------------------------
    # internals

    def _one_step(self):
        """One step: a dispatch of one through the chunk when there is
        one (a graph replay on the card), else the eager update."""
        if self.chunked_update_fn is None:
            return self.update_fn(self.input_img, self.opt_state)
        image, state, auxes = self.chunked_update_fn(
            self.input_img, self.opt_state, 1,
        )
        return image, state, auxes.at(0)

    def _whole(self, image: torch.Tensor) -> torch.Tensor:
        """The whole image: gathered from every rank on a mesh."""
        return image if self._mesh is None else self._mesh.gather(image)

    def _fetch_frame(self, image: torch.Tensor) -> torch.Tensor:
        # Denorm, scrub, the luminance transfer and uint8 packing run on
        # the device, on this thread, with no host copy; only H*W*3
        # bytes cross to the host.
        prepared = maybe_restore_color(
            image_io.prepare_image_for_output(
                image, normalize=self.config.optimization.normalize,
            ),
            self._chroma_source,
        )
        return image_io.pack_uint8_frame(prepared)

    def _configure_logging(self) -> None:
        out_cfg = self.config.output
        steps = self.total_steps
        track_history = True
        self.loss_logger = None

        if out_cfg.log_loss and self._writes:
            try:
                self.loss_logger = LossCSVLogger(
                    out_cfg.log_loss, out_cfg.log_every,
                    resume=self._start_step > 0,
                )
                logger.info(
                    "Loss CSV logging enabled: %s", out_cfg.log_loss,
                )
                track_history = False
            except OSError as exc:
                logger.error("Failed to initialize CSV logging: %s", exc)
                if self.callbacks.on_logging_error is not None:
                    self.callbacks.on_logging_error(exc)
                track_history = True

        capacity = min(steps, DEFAULT_HISTORY_CAPACITY)
        self._accumulator = LossAccumulator(
            log_every=out_cfg.log_every,
            history_capacity=capacity,
            track_history=track_history,
            device=self.input_img.device,
        )

        if track_history and steps > capacity:
            logger.warning(
                "Long run detected (%d steps). In-memory loss history is "
                "capped at %d entries; enable --log-loss for a full CSV.",
                steps, capacity,
            )
        elif track_history and steps > CSV_LOGGING_RECOMMENDED_STEPS:
            logger.warning(
                "Long run detected (%d steps). Consider enabling "
                "--log-loss to capture every step.",
                steps,
            )

    def _resolve_chunk_size(self) -> int:
        """Steps per ``chunked_update_fn`` call.

        The chunk divides every cadence whose contract is per-step host
        work at exact steps: CSV rows (``log_every``), frames
        (``save_every`` when a sink is attached) and checkpoints
        (``checkpoint_every``). The ring is not a
        constraint: a chunk records every step's losses.
        ``hardware.steps_per_dispatch`` tunes it (:func:`dispatch_chunk`);
        per-step callbacks force single steps.
        """
        if self.chunked_update_fn is None:
            return 1
        if (
            self.callbacks.on_step_start is not None
            or self.callbacks.on_step_end is not None
        ):
            return 1
        cadences = []
        if self._csv_on:
            cadences.append(self.config.output.log_every)
        if self._frames_on:
            cadences.append(self.config.video.save_every)
        if self.config.output.checkpoint_every:
            cadences.append(self.config.output.checkpoint_every)
        return dispatch_chunk(
            self.config.hardware.steps_per_dispatch, cadences,
        )

    def _finalize_chunk(self, first_step: int, k: int, auxes) -> None:
        """Bookkeeping for a k-step chunk (stacked StepAux tensors)."""
        last_step = first_step + k - 1
        self._step_index = last_step
        self._eval_total = self._eval_total + auxes.n_evals.sum()

        logged = self._accumulator.accumulate_batch(
            first_step, auxes.style_score, auxes.content_score, auxes.loss,
        )
        self._after_record(last_step, logged)
        self._maybe_save_checkpoint(last_step)
        self.progress_bar.update(k)

    def _finalize_step(self, step_idx: int, aux: StepAux) -> None:
        self._step_index = step_idx
        self._eval_total = self._eval_total + aux.n_evals

        logged = self._accumulator.accumulate(
            step_idx, aux.style_score, aux.content_score, aux.loss,
        )
        metrics = self._after_record(step_idx, logged)
        self._maybe_save_checkpoint(step_idx)
        self.progress_bar.update(1)
        if self.callbacks.on_step_end is not None:
            self.callbacks.on_step_end(metrics)

    def _maybe_save_checkpoint(self, step_idx: int) -> None:
        cadence = self.config.output.checkpoint_every
        if (
            not cadence
            or self._checkpoint_path is None
            or step_idx % cadence != 0
        ):
            return
        image, state = self.input_img, self.opt_state
        with span("stv.loop.checkpoint"):
            if self._mesh is not None:
                image = self._mesh.gather(image)
                state = gather_state(self._mesh, state)
            if self._writes:
                save_checkpoint(
                    self._checkpoint_path, step_idx, image, state,
                )

    def _after_record(
        self, step_idx: int, logged: LoggedLoss | None,
    ) -> StepMetrics:
        """CSV row, warnings and the frame for the step just recorded."""
        if logged is not None:
            if self.loss_logger is not None:
                self.loss_logger.log(
                    logged.step,
                    logged.style_loss,
                    logged.content_loss,
                    logged.total_loss,
                )
            self._latest_logged = logged
            self._warn_nonfinite(logged)
            metrics = StepMetrics(
                step=logged.step,
                style_loss=logged.style_loss,
                content_loss=logged.content_loss,
                total_loss=logged.total_loss,
            )
        else:
            metrics = StepMetrics(step=step_idx)
        self._maybe_write_video_frame(metrics)
        return metrics

    @staticmethod
    def _warn_nonfinite(logged: LoggedLoss) -> None:
        if not math.isfinite(logged.style_loss):
            logger.warning(
                "Non-finite style score at step %d", logged.step,
            )
        if not math.isfinite(logged.content_loss):
            logger.warning(
                "Non-finite content score at step %d", logged.step,
            )
        if not math.isfinite(logged.total_loss):
            logger.warning(
                "Non-finite total loss at step %d, using previous loss",
                logged.step,
            )

    def _maybe_write_video_frame(self, metrics: StepMetrics) -> None:
        save_every = self.config.video.save_every
        step_idx = metrics.step
        if step_idx % save_every != 0 or not self._frames_on:
            return
        image = self._whole(self.input_img)
        if not self._writes:
            return

        device_frame = self._fetch_frame(image)
        if self._async_frames:
            if self._frame_stream is None:
                self._frame_stream = AsyncFrameStream()
            self._frame_stream.submit(
                device_frame,
                lambda frame, m=metrics: self._deliver_frame(frame, m),
            )
        else:
            with span("stv.frames.submit"):
                self._deliver_frame(device_frame.cpu().numpy(), metrics)

    def _deliver_frame(self, img_np: np.ndarray, metrics: StepMetrics) -> None:
        if (
            self.intro_last_frame is not None
            and not self.intro_transition_done
        ):
            if (
                self.video_writer is not None
                and self.config.video.intro_enabled
            ):
                append_crossfade(
                    self.video_writer,
                    self.intro_last_frame,
                    img_np,
                    self.intro_crossfade_frames,
                )
            if (
                self.gif_collector is not None
                and self.config.video.gif_include_intro
            ):
                append_crossfade(
                    self.gif_collector,
                    self.intro_last_frame,
                    img_np,
                    self.intro_crossfade_frames,
                )
            self.intro_transition_done = True
            self.intro_last_frame = None

        if self.video_writer is not None:
            self.video_writer.append_data(img_np)
        if self.gif_collector is not None:
            self.gif_collector.append_data(img_np)

        self._update_progress_postfix(metrics)

        if self.callbacks.on_video_frame is not None:
            self.callbacks.on_video_frame(img_np, metrics.step)

    def _update_progress_postfix(self, metrics: StepMetrics) -> None:
        display = metrics
        if not metrics.has_values and self._latest_logged is not None:
            display = StepMetrics(
                step=self._latest_logged.step,
                style_loss=self._latest_logged.style_loss,
                content_loss=self._latest_logged.content_loss,
                total_loss=self._latest_logged.total_loss,
            )
        postfix: dict[str, str] = {}
        if display.style_loss is not None:
            postfix["style"] = f"{display.style_loss:.4f}"
        if display.content_loss is not None:
            postfix["content"] = f"{display.content_loss:.4f}"
        if display.total_loss is not None:
            postfix["loss"] = f"{display.total_loss:.4f}"
        if postfix:
            self.progress_bar.set_postfix(postfix)

    def _log_summary(self) -> None:
        steps_run = self._step_index - self._start_step
        if steps_run <= 0:
            return
        # One host read for the whole run's evaluation telemetry.
        total_evals = int(self._eval_total)
        logger.info(
            "Optimization finished with %d accepted steps and %d closure "
            "evaluations (%.2f closures/step).",
            steps_run, total_evals, total_evals / steps_run,
        )

    def _cleanup(self) -> None:
        """Close every resource; never let one failure skip the others.

        Runs inside ``run()``'s finally: when the loop itself raised, a
        cleanup error must not replace it, so close errors are logged.
        A frame-stream error (a sink rejected a frame on the worker
        thread) is a run failure and is re-raised when it is the only
        thing that went wrong.
        """
        loop_failed = sys.exc_info()[1] is not None
        stream_error: BaseException | None = None

        if self._frame_stream is not None:
            stream, self._frame_stream = self._frame_stream, None
            try:
                stream.close()
            except BaseException as exc:  # noqa: BLE001
                stream_error = exc
                logger.error("Error closing frame stream: %s", exc)

        if self.loss_logger is not None:
            try:
                self.loss_logger.close()
            except OSError as exc:
                logger.error("Error closing loss logger: %s", exc)

        if self._owns_progress_bar and self._progress_bar is not None:
            try:
                self._progress_bar.close()
            except Exception as exc:  # noqa: BLE001
                logger.error("Error closing progress bar: %s", exc)

        if stream_error is not None and not loop_failed:
            raise stream_error
