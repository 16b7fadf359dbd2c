"""Asynchronous device-to-host frame streaming.

The runner submits a *device* uint8 frame (packed on the device) with a
delivery callback; a worker thread hands the callback a host numpy
array. Step dispatch never waits for a frame:

- on a CUDA tensor, :meth:`AsyncFrameStream.submit` runs on the issuing
  thread and never waits for the device. It takes a page-locked host
  buffer from a pool of ``max_queue + 1`` (allocated once, at the first
  frame), enqueues a ``non_blocking`` copy into it on the stream that
  produced the frame and records a CUDA event after the copy. The
  (buffer, event, callback) triples are staged and queued in batches
  (below). The worker waits on each event whose copy has not landed,
  copies the batch's buffers into fresh host memory in one call,
  returns the buffers to the pool and delivers one array per frame,
  which no later frame overwrites (sinks and frame callbacks may keep
  it). No ``synchronize()``, ``.item()``, ``.cpu()`` or ``.numpy()`` of
  a device tensor runs on the issuing thread;
- on a CPU tensor (the tests), the frame is already computed: submit
  queues ``frame.numpy().copy()``.

Batches: the issuing thread is host-bound (it launches the step's many
small operations), and every wake-up of the worker costs it a GIL
hand-off, which is slow where thread wake-ups are (about a millisecond
of the issuing thread's time on the H100 host that
``tools/frame_overhead.py`` measured). So CUDA frames go to
the worker ``max_queue // 2`` at a time: a batch is queued when one
more frame has been staged behind it (by then its copies have usually
landed), or at drain and close. The worker then takes the GIL about
twice per batch: once to wake, once after the batch's copy. A frame
reaches its sink at most ``max_queue // 2 + 1`` submits late, or at
drain or close.

A bounded FIFO keeps the frame order (the intro crossfade comes before
the first stylized frame) and gives backpressure: with every pinned
buffer in flight, submit waits for the worker to return some. A worker
error is raised at the next submit or at close. Any other device type
raises: there is no path that hides the device.
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

FrameCallback = Callable[[np.ndarray], None]
_SENTINEL = None


class _Slot(NamedTuple):
    """A page-locked buffer and the event recorded after its copy."""

    buffer: torch.Tensor
    event: torch.cuda.Event


class _PinnedPool:
    """Page-locked host buffers with events, handed out one at a time."""

    def __init__(self, shape: torch.Size, dtype: torch.dtype, n: int):
        self.shape = shape
        self.dtype = dtype
        self._free: queue.SimpleQueue[_Slot] = queue.SimpleQueue()
        for _ in range(n):
            # A blocking event: a worker that must wait sleeps instead
            # of spinning on a core the issuing thread may share.
            self._free.put(_Slot(
                torch.empty(shape, dtype=dtype, pin_memory=True),
                torch.cuda.Event(blocking=True),
            ))

    def take(self) -> _Slot:
        """A free slot; waits while all are in flight."""
        return self._free.get()

    def give(self, slot: _Slot) -> None:
        """Return a slot whose copy has been read."""
        self._free.put(slot)


class AsyncFrameStream:
    """Bounded FIFO pipeline: device frame -> host numpy -> callback."""

    def __init__(self, max_queue: int = 8) -> None:
        self._max_queue = max_queue
        self._batch = max(1, max_queue // 2)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._pool: _PinnedPool | None = None
        self._staged: list[tuple[_Slot, FrameCallback]] = []
        self._error: BaseException | None = None
        self._worker = threading.Thread(
            target=self._run, name="stv-frame-stream", daemon=True,
        )
        self._closed = False
        self._worker.start()

    def submit(self, device_frame: torch.Tensor, deliver: FrameCallback):
        """Enqueue a frame for host delivery; never waits for the device.

        Blocks only when every buffer is in flight (encoder
        backpressure). Raises any error the worker hit on a previous
        frame.
        """
        self._raise_pending()
        if self._closed:
            msg = "Cannot submit frames after stream close."
            raise RuntimeError(msg)
        if device_frame.device.type == "cuda":
            self._staged.append((self._stage_cuda(device_frame), deliver))
            if len(self._staged) > self._batch:
                batch = self._staged[:self._batch]
                del self._staged[:self._batch]
                self._queue.put(batch)
        elif device_frame.device.type == "cpu":
            self._queue_staged()
            self._queue.put((device_frame.numpy().copy(), deliver))
        else:
            msg = f"No frame path for device {device_frame.device}"
            raise ValueError(msg)

    def _stage_cuda(self, frame: torch.Tensor) -> _Slot:
        if self._pool is None:
            self._pool = _PinnedPool(
                frame.shape, frame.dtype, self._max_queue + 1,
            )
        elif (frame.shape, frame.dtype) != (
            self._pool.shape, self._pool.dtype,
        ):
            msg = (
                f"Frame {tuple(frame.shape)} {frame.dtype} does not match "
                f"the stream's {tuple(self._pool.shape)} {self._pool.dtype}"
            )
            raise ValueError(msg)
        slot = self._pool.take()
        # On the frame's own stream: the copy is ordered after the
        # kernels that produced the frame, and the frame's memory is
        # reused only by later work on that same stream.
        slot.buffer.copy_(frame, non_blocking=True)
        slot.event.record(torch.cuda.current_stream(frame.device))
        return slot

    def _queue_staged(self) -> None:
        """Queue every staged CUDA frame as one batch."""
        if self._staged:
            batch, self._staged = self._staged, []
            self._queue.put(batch)

    def drain(self) -> None:
        """Block until every submitted frame has been delivered."""
        self._queue_staged()
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker, and surface any pending error."""
        if self._closed:
            return
        self._closed = True
        self._queue_staged()
        self._queue.join()
        self._queue.put(_SENTINEL)
        self._worker.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                self._queue.task_done()
                return
            try:
                if isinstance(item, list):
                    self._deliver_batch(item)
                elif self._error is None:
                    frame, deliver = item
                    deliver(frame)
            except BaseException as exc:  # noqa: BLE001
                self._error = exc
            finally:
                self._queue.task_done()

    def _deliver_batch(self, batch: list[tuple[_Slot, FrameCallback]]):
        try:
            for slot, _ in batch:
                # query() keeps the GIL; synchronize() gives it up and
                # sleeps, only when the copy has not landed.
                if not slot.event.query():
                    slot.event.synchronize()
            # One copy for the batch, into memory of its own: the GIL is
            # given up once, and the fresh pages fault in off it.
            frames = torch.stack([slot.buffer for slot, _ in batch]).numpy()
        finally:
            for slot, _ in batch:
                self._pool.give(slot)
        for frame, (_, deliver) in zip(frames, batch, strict=True):
            if self._error is None:
                deliver(frame)
