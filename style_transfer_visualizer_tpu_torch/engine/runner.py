"""The step loop: dispatch, loss history, and host syncs at a cadence.

The port of the JAX package's ``engine/runner.py`` and
``engine/loss_accumulator.py`` for a run without media. Steps run in
chunks that end on the ``log_every`` grid; per-step losses stay on the
device in one ``(steps, 3)`` tensor, and the host reads a loss back
only at each ``log_every`` step and at the end, so the device is never
waited on in between. Non-finite losses are warned about at those
reads.
"""
from __future__ import annotations

import math
import time
from typing import TYPE_CHECKING

import torch

from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import (
        StyleTransferConfig,
    )
    from style_transfer_visualizer_tpu_torch.engine.step import StepBundle
    from style_transfer_visualizer_tpu_torch.type_defs import LossHistory

_SERIES = ("style_loss", "content_loss", "total_loss")


class OptimizationRunner:
    """Run the update loop with cadence-gated loss logging."""

    def __init__(
        self,
        bundle: StepBundle,
        input_img: torch.Tensor,
        config: StyleTransferConfig,
    ) -> None:
        self.bundle = bundle
        self.opt_state = bundle.opt_state
        self.input_img = input_img
        self.config = config

    def run(self) -> tuple[torch.Tensor, LossHistory, float]:
        """Execute the loop; return (image, loss history, elapsed s)."""
        steps = self.config.optimization.steps
        log_every = self.config.output.log_every
        device = self.input_img.device
        rows = torch.empty((steps, 3), dtype=torch.float32, device=device)
        evals = torch.zeros((), dtype=torch.int64, device=device)
        start = time.perf_counter()
        step = 0
        while step < steps:
            k = min(log_every - step % log_every, steps - step)
            self.input_img, self.opt_state, aux = (
                self.bundle.chunked_update_fn(
                    self.input_img, self.opt_state, k,
                )
            )
            rows[step:step + k] = torch.stack(
                [aux.style_score, aux.content_score, aux.loss], dim=1,
            ).float()
            evals = evals + aux.n_evals.sum()
            step += k
            if step % log_every == 0:
                self._log(step, rows[step - 1].tolist())
        history = rows.cpu()
        elapsed = time.perf_counter() - start
        if steps % log_every:
            self._log(steps, history[-1].tolist())
        total_evals = int(evals)
        logger.info(
            "Optimization finished with %d accepted steps and %d closure "
            "evaluations (%.2f closures/step).",
            steps, total_evals, total_evals / steps,
        )
        return (
            self.input_img,
            {name: history[:, i].tolist() for i, name in enumerate(_SERIES)},
            elapsed,
        )

    @staticmethod
    def _log(step: int, row: list[float]) -> None:
        style, content, total = row
        logger.info(
            "Step %d: style %.6g content %.6g total %.6g",
            step, style, content, total,
        )
        if not math.isfinite(style):
            logger.warning("Non-finite style score at step %d", step)
        if not math.isfinite(content):
            logger.warning("Non-finite content score at step %d", step)
        if not math.isfinite(total):
            logger.warning("Non-finite total loss at step %d", step)
