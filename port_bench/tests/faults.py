"""Faults planted under the timed path, for the tests that see the check
fail (``run.py --plant port_bench.tests.faults:<name>``).

Each function patches the port in the process that calls it, before
the window runs: every rank of a mesh calls it.
"""
from __future__ import annotations

import torch


def _wrap_steps(make):
    """Replace the single and batched optimizer steps where the step
    builders call them with ``make(real)``."""
    from style_transfer_visualizer_tpu_torch.engine import step
    from style_transfer_visualizer_tpu_torch.parallel import multistyle

    for module, names in (
        (step, ("lbfgs_step", "adam_step")),
        (multistyle, ("lbfgs_step_batched", "adam_step_batched")),
    ):
        for name in names:
            setattr(module, name, make(getattr(module, name)))


def state_unchanged() -> None:
    """Every step returns the image it was given."""

    def make(real):
        def step(vag, x, state, lr, **kwargs):
            _, new_state, aux = real(vag, x, state, lr, **kwargs)
            return x, new_state, aux

        return step

    _wrap_steps(make)


def half_batch() -> None:
    """Every step updates only the first half of its batch: the first
    half of the styles, or of a single image's pixels."""

    def make(real):
        def step(vag, x, state, lr, **kwargs):
            new_x, new_state, aux = real(vag, x, state, lr, **kwargs)
            kept = new_x.clone()
            if x.dim() >= 2 and x.shape[0] > 1:  # noqa: PLR2004
                kept[x.shape[0] // 2:] = x[x.shape[0] // 2:]
            else:
                flat, old = kept.view(-1), x.reshape(-1)
                flat[flat.numel() // 2:] = old[flat.numel() // 2:]
            return kept, new_state, aux

        return step

    _wrap_steps(make)


def no_exchange() -> None:
    """The ranks of a row exchange nothing: no halo rows, no sums of
    the Gram and content partials."""
    from style_transfer_visualizer_tpu_torch.parallel import spatial

    def halos(x, mesh):
        zero = x.new_zeros((x.shape[0], 1, *x.shape[2:]))
        return torch.cat([zero, x, zero], dim=1)

    spatial.psum = lambda t, mesh: t
    spatial._with_halos = halos  # noqa: SLF001


def scale_swapped() -> None:
    """Each style of a batch takes its L-BFGS direction with the next
    style's scale ``gamma`` (its own ring)."""
    import dataclasses

    from style_transfer_visualizer_tpu_torch.engine import optimizers

    real = optimizers._style  # noqa: SLF001

    def style(st, i):
        other = (i + 1) % st.hist_len.shape[0]
        return dataclasses.replace(real(st, i), h_diag=st.h_diag[other])

    optimizers._style = style  # noqa: SLF001


def altered_answer() -> None:
    """Every step's reported style score is 1% high where it is made."""
    from style_transfer_visualizer_tpu_torch.engine import optimizers

    real = optimizers.StepAux

    def aux(loss, style_score, content_score, n_evals):
        return real(loss, style_score * 1.01, content_score, n_evals)

    optimizers.StepAux = aux
