"""Loss-curve plotting (matplotlib optional, deferred import).

The port's own copy of the JAX package's ``visualization/metrics.py``:
``loss_plot.png`` in the output directory, one line per non-empty
series, warnings instead of errors when there is nothing to plot or no
matplotlib available.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from pathlib import Path

    from style_transfer_visualizer_tpu_torch.type_defs import LossHistory

_PLOT_FILENAME = "loss_plot.png"
_FIGSIZE = (10, 6)


def _import_pyplot():
    """Deferred import keeps matplotlib an optional dependency."""
    try:
        import matplotlib.pyplot as plt  # noqa: PLC0415
    except ImportError:
        return None
    return plt


def plot_loss_curves(
    metrics: LossHistory,
    output_dir: Path,
    filename: str = _PLOT_FILENAME,
) -> None:
    """Save a loss plot for the recorded series, if any.

    ``filename`` defaults to ``loss_plot.png``.
    """
    if not metrics:
        logger.warning("No loss metrics dictionary provided.")
        return

    series = {name: vals for name, vals in metrics.items() if vals}
    if not series:
        logger.warning("Loss metrics dictionary is empty, nothing to plot.")
        return

    plt = _import_pyplot()
    if plt is None:
        logger.warning("matplotlib not found: skipping loss plot.")
        return

    figure = plt.figure(figsize=_FIGSIZE)
    try:
        for name, values in series.items():
            plt.plot(values, label=name)
        plt.xlabel("Step")
        plt.ylabel("Loss")
        plt.title("Loss Curves")
        plt.legend()
        plt.tight_layout()
        out = output_dir / filename
        plt.savefig(out)
        logger.info("Loss plot saved to: %s", out)
    finally:
        plt.close(figure)
