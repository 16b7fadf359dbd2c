"""Builds the per-step L-BFGS update for a style-transfer run.

The port of the JAX package's ``engine/step.py`` for L-BFGS: the loss
and its gradient come from autograd through the feature path (whose
convs and Grams run the CUDA kernels on the card), and the optimizer
update follows. PyTorch runs eagerly, so there is no jit; the k-step
chunk is a plain Python loop. Metrics stay device tensors; the caller
decides when to read them.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    LbfgsState,
    StepAux,
    lbfgs_init,
    lbfgs_step,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    total_loss,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params

_HISTORY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# update(image, opt_state) -> (image, opt_state, StepAux)
UpdateFn = Callable[
    [torch.Tensor, LbfgsState], tuple[torch.Tensor, LbfgsState, StepAux],
]


@dataclass
class StepBundle:
    """An update function with its initial optimizer state.

    ``chunked_update_fn(image, state, k)`` runs ``k`` steps and returns
    the per-step ``StepAux`` fields stacked along a leading ``k`` axis.
    """

    update_fn: UpdateFn
    opt_state: LbfgsState
    chunked_update_fn: Callable


def build_update_step(
    params: Params,
    targets: Targets,
    image_shape: tuple[int, ...],
    *,
    lr: float,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    lbfgs_max_iter: int = 1,
    lbfgs_max_eval: int = 1,
    lbfgs_history_size: int = 100,
    lbfgs_history_dtype: str = "float32",
    lbfgs_direction: str = "two-loop",
) -> StepBundle:
    """Build ``update(image, state) -> (image, state, StepAux)``.

    ``image`` is the working ``(1, H, W, 3)`` tensor in (possibly
    normalized) model space. The L-BFGS ring lives on the device of the
    weights, which is the run's device.
    """
    try:
        history_dtype = _HISTORY_DTYPES[lbfgs_history_dtype]
    except KeyError:
        msg = f"Unknown L-BFGS history dtype: {lbfgs_history_dtype!r}"
        raise ValueError(msg) from None
    device = next(iter(params.values()))["w9"].device
    n = 1
    for dim in image_shape:
        n *= int(dim)
    style_layers = tuple(style_layers)
    content_layers = tuple(content_layers)

    def vag(flat: torch.Tensor):
        with torch.enable_grad():
            x = flat.detach().requires_grad_(True)
            total, (style, content) = total_loss(
                params, x.reshape(image_shape), targets, style_w, content_w,
                style_layers, content_layers,
            )
            (grad,) = torch.autograd.grad(total, x)
        return (total.detach(), (style.detach(), content.detach())), grad

    def update_fn(image: torch.Tensor, state: LbfgsState):
        new_flat, new_state, aux = lbfgs_step(
            vag, image.reshape(n), state, lr,
            max_iter=lbfgs_max_iter,
            max_eval=lbfgs_max_eval,
            direction_method=lbfgs_direction,
        )
        return new_flat.reshape(image_shape), new_state, aux

    def chunked_update_fn(image: torch.Tensor, state: LbfgsState, k: int):
        auxes: list[StepAux] = []
        for _ in range(k):
            image, state, aux = update_fn(image, state)
            auxes.append(aux)
        stacked = StepAux(
            *(
                torch.stack([getattr(a, f) for a in auxes])
                for f in ("loss", "style_score", "content_score", "n_evals")
            ),
        )
        return image, state, stacked

    return StepBundle(
        update_fn=update_fn,
        opt_state=lbfgs_init(
            n, lbfgs_history_size, device, history_dtype,
        ),
        chunked_update_fn=chunked_update_fn,
    )
