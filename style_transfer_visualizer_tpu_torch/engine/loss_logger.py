"""CSV loss logging at a fixed step cadence.

The port's own copy of the JAX package's ``engine/loss_logger.py``:
header ``step,style_loss,content_loss,total_loss``, rows written and
flushed every ``log_every`` steps, context-manager close.
"""
from __future__ import annotations

import csv
from pathlib import Path
from types import TracebackType

_HEADER = ("step", "style_loss", "content_loss", "total_loss")


class LossCSVLogger:
    """Append loss rows to a CSV file at the configured cadence.

    With ``resume=True`` an existing file is appended to instead of
    truncated (the header is only written for a fresh file) — used when
    restarting from a checkpoint so the interrupted run's rows survive.
    """

    def __init__(
        self,
        path: str | Path,
        log_every: int,
        *,
        resume: bool = False,
    ) -> None:
        self.path = Path(path)
        self.log_every = log_every
        self.path.parent.mkdir(parents=True, exist_ok=True)
        appending = resume and self.path.is_file()
        self.file = self.path.open(
            "a" if appending else "w", newline="", encoding="utf-8",
        )
        self.writer = csv.writer(self.file)
        if not appending:
            self.writer.writerow(_HEADER)
            self.file.flush()

    def log(
        self,
        step: int,
        style_loss: float,
        content_loss: float,
        total_loss: float,
    ) -> None:
        """Write a row when ``step`` lands on the cadence, flushing."""
        if self.writer and step % self.log_every == 0:
            self.writer.writerow([step, style_loss, content_loss, total_loss])
            self.file.flush()

    def close(self) -> None:
        """Close the file handle (idempotent)."""
        if self.file and not self.file.closed:
            self.file.close()

    def __enter__(self) -> LossCSVLogger:
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        self.close()
