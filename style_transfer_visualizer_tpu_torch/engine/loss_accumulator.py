"""Device-side loss history with batched host synchronization.

The port of the JAX package's ``engine/loss_accumulator.py``. Per-step
loss scalars stay on the device: each step's row goes into a ring of
``history_capacity`` rows by an indexed copy on the device's stream, and
losses become Python floats only at the ``log_every`` cadence (one
transfer of three scalars). Exporting the history reads the ring once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.type_defs import LossHistory

DEFAULT_HISTORY_CAPACITY = 2048


@dataclass(slots=True)
class LoggedLoss:
    """Host-synced scalar losses."""

    step: int
    style_loss: float
    content_loss: float
    total_loss: float


class LossAccumulator:
    """Ring-buffered device-side loss history with cadence-gated syncs."""

    def __init__(
        self,
        *,
        log_every: int,
        history_capacity: int | None,
        track_history: bool,
        device: torch.device | str | None = None,
    ) -> None:
        self._log_every = max(1, log_every)
        self._capacity = max(1, history_capacity or DEFAULT_HISTORY_CAPACITY)
        self._track_history = track_history
        self._device = device

        self._buffer: torch.Tensor | None = None
        if track_history:
            self._buffer = torch.zeros(
                (self._capacity, 3), dtype=torch.float32, device=device,
            )
        self._write_index = 0
        self._count = 0
        self._total_records = 0
        self._truncated = False

        self._pending: (
            tuple[int, torch.Tensor, torch.Tensor, torch.Tensor] | None
        ) = None
        self._last_logged: LoggedLoss | None = None

    @property
    def tracks_history(self) -> bool:
        """Whether per-step history is being recorded."""
        return self._track_history

    @property
    def history_truncated(self) -> bool:
        """Whether the ring buffer has overwritten old entries."""
        return self._truncated

    def accumulate(
        self,
        step_idx: int,
        style_loss: torch.Tensor,
        content_loss: torch.Tensor,
        total_loss: torch.Tensor,
    ) -> LoggedLoss | None:
        """Record device scalars; sync to floats only on cadence."""
        self._pending = (step_idx, style_loss, content_loss, total_loss)
        if self._track_history:
            self._write_rows(
                torch.stack([style_loss, content_loss, total_loss])[None],
            )
        if step_idx % self._log_every == 0:
            return self._sync_pending()
        return None

    def accumulate_batch(
        self,
        first_step: int,
        style_losses: torch.Tensor,
        content_losses: torch.Tensor,
        total_losses: torch.Tensor,
    ) -> LoggedLoss | None:
        """Record a chunk of k consecutive per-step device scalars.

        Every step lands in the ring. A host sync happens whenever a
        ``log_every`` boundary falls inside the chunk, reporting the
        chunk's last step: when chunks divide ``log_every`` (the runner
        guarantees it whenever CSV logging is on) that is exactly the
        cadence step.
        """
        k = int(style_losses.shape[0])
        if k == 0:
            return None
        last_step = first_step + k - 1
        self._pending = (
            last_step, style_losses[-1], content_losses[-1], total_losses[-1],
        )
        if self._track_history:
            self._write_rows(
                torch.stack([style_losses, content_losses, total_losses], 1),
            )
        crossed_boundary = (
            last_step // self._log_every
            != (first_step - 1) // self._log_every
        )
        if crossed_boundary:
            return self._sync_pending()
        return None

    def latest(self) -> LoggedLoss | None:
        """Most recent host-synced values."""
        return self._last_logged

    def export_history(self) -> LossHistory:
        """Unroll the ring buffer into per-series host lists."""
        empty: LossHistory = {
            "style_loss": [], "content_loss": [], "total_loss": [],
        }
        if not self._track_history or self._count == 0:
            return empty
        buf = self._buffer.cpu().numpy()
        start = (self._write_index - self._count) % self._capacity
        rows = np.take(
            buf, (start + np.arange(self._count)) % self._capacity, axis=0,
        )
        return {
            "style_loss": rows[:, 0].tolist(),
            "content_loss": rows[:, 1].tolist(),
            "total_loss": rows[:, 2].tolist(),
        }

    def _write_rows(self, rows: torch.Tensor) -> None:
        """Copy k rows into the ring at the write index, wrapping.

        The write index lives on the host, so the copy splits into at
        most two slices there and nothing waits on the device.
        """
        rows = rows.to(torch.float32)
        k = int(rows.shape[0])
        cap = self._capacity
        if k >= cap:
            self._buffer.copy_(rows[-cap:])
            self._write_index = 0
            k_eff = cap
        else:
            head = min(k, cap - self._write_index)
            w = self._write_index
            self._buffer[w:w + head] = rows[:head]
            if head < k:
                self._buffer[:k - head] = rows[head:]
            self._write_index = (w + k) % cap
            k_eff = k
        self._count = min(self._count + k_eff, cap)
        self._total_records += k
        if self._total_records > cap:
            self._truncated = True

    def _sync_pending(self) -> LoggedLoss | None:
        if self._pending is None:
            return None
        step_idx, style, content, total = self._pending
        # One transfer for all three scalars.
        vals = torch.stack([style, content, total]).to(torch.float32)
        style_f, content_f, total_f = vals.tolist()
        logged = LoggedLoss(
            step=step_idx,
            style_loss=style_f,
            content_loss=content_f,
            total_loss=total_f,
        )
        self._last_logged = logged
        return logged
