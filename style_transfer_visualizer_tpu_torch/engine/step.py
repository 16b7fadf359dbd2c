"""Builds the per-step update (L-BFGS or Adam) for a style-transfer run.

The port of the JAX package's ``engine/step.py``: the loss and its
gradient come from autograd through the feature path (whose convs and
Grams run the CUDA kernels on the card), plus the optional TV and
Laplacian terms on the image, and the optimizer update follows.
PyTorch runs eagerly, so there is no jit; the k-step chunk is a plain
Python loop. Metrics stay device tensors; the caller decides when to
read them.

:func:`targets_update` is the update with its weights and targets as
arguments of every call (the sequence, the blend sweep and the
regional run build on it, through ``sequence.build_targets_update``);
:func:`build_update_step` binds one set of targets to it, so both run
the same arithmetic.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    AdamState,
    LbfgsState,
    StepAux,
    adam_init,
    adam_step,
    lbfgs_init,
    lbfgs_step,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    total_loss,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.lap import lap_loss
from style_transfer_visualizer_tpu_torch.ops.tv import tv_loss

HISTORY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

OptState = LbfgsState | AdamState

# update(image, opt_state) -> (image, opt_state, StepAux)
UpdateFn = Callable[
    [torch.Tensor, OptState], tuple[torch.Tensor, OptState, StepAux],
]


@dataclass
class StepBundle:
    """An update function with its initial optimizer state.

    ``chunked_update_fn(image, state, k)`` runs ``k`` steps and returns
    the per-step ``StepAux`` fields stacked along a leading ``k`` axis.
    """

    update_fn: UpdateFn
    opt_state: OptState
    chunked_update_fn: Callable


def drive_chunked(
    chunked_update: Callable,
    image: torch.Tensor,
    state: OptState,
    steps: int,
    chunk: int,
):
    """Run ``steps`` updates through ``chunked_update``, ``chunk`` at a time.

    Returns the final image and state and the *last* chunk's stacked
    aux (None when ``steps`` is 0).
    """
    auxes = None
    remaining = steps
    while remaining > 0:
        k = min(chunk, remaining)
        image, state, auxes = chunked_update(image, state, k)
        remaining -= k
    return image, state, auxes


# loss_fn(params, image, targets) -> (total, (style_score, content_score))
LossFn = Callable[
    ..., tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]],
]


def make_objective(
    *,
    style_w: float,
    content_w: float,
    tv_w: float = 0.0,
    lap_w: float = 0.0,
    lap_pool: int = 4,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None = None,
) -> LossFn:
    """The style + content objective, plus the optional TV and Laplacian
    terms, as ``loss_fn(params, image, targets)``.

    ``targets`` is a ``Targets``; with ``lap_w`` set it is the pair
    ``(Targets, lap_target)``, the Laplacian response
    (``ops.lap.lap_response``) the image is held to.
    """
    style_layers = tuple(style_layers)
    content_layers = tuple(content_layers)

    def loss_fn(params: Params, img: torch.Tensor, targets):
        lap_target = None
        if lap_w:
            targets, lap_target = targets
        total, aux = total_loss(
            params, img, targets, style_w, content_w,
            style_layers, content_layers, style_weights,
        )
        if tv_w:
            total = total + tv_w * tv_loss(img)
        if lap_w:
            total = total + lap_w * lap_loss(img, lap_target, lap_pool)
        return total, aux

    return loss_fn


def targets_update(
    loss_fn: LossFn,
    image_shape: tuple[int, ...],
    device: torch.device,
    *,
    optimizer: str = "lbfgs",
    lr: float,
    lbfgs_max_iter: int = 1,
    lbfgs_max_eval: int = 1,
    lbfgs_history_size: int = 100,
    lbfgs_history_dtype: str = "float32",
    lbfgs_direction: str = "two-loop",
) -> tuple[Callable, Callable[[], OptState]]:
    """``(update, init_state)`` for an objective whose targets are an
    argument.

    ``update(image, state, params, targets) -> (image, state,
    StepAux)`` takes the weights and the targets on every call, so one
    update serves any number of target sets (the frames of a sequence,
    the mixtures of a blend sweep). ``init_state()`` makes a fresh
    optimizer state on ``device``. The gradient is autograd's through
    ``loss_fn(params, image, targets)``.
    """
    n = 1
    for dim in image_shape:
        n *= int(dim)

    def vag(x_in: torch.Tensor, params: Params, targets):
        with torch.enable_grad():
            x = x_in.detach().requires_grad_(True)
            total, (style, content) = loss_fn(
                params, x.reshape(image_shape), targets,
            )
            (grad,) = torch.autograd.grad(total, x)
        return (total.detach(), (style.detach(), content.detach())), grad

    if optimizer == "lbfgs":
        try:
            history_dtype = HISTORY_DTYPES[lbfgs_history_dtype]
        except KeyError:
            msg = f"Unknown L-BFGS history dtype: {lbfgs_history_dtype!r}"
            raise ValueError(msg) from None

        def init_state() -> OptState:
            return lbfgs_init(n, lbfgs_history_size, device, history_dtype)

        def update(image: torch.Tensor, state: LbfgsState, params, targets):
            new_flat, new_state, aux = lbfgs_step(
                lambda x: vag(x, params, targets), image.reshape(n), state,
                lr,
                max_iter=lbfgs_max_iter,
                max_eval=lbfgs_max_eval,
                direction_method=lbfgs_direction,
            )
            return new_flat.reshape(image_shape), new_state, aux

    elif optimizer == "adam":
        # The moments carry the image's own shape: no flatten per step.
        def init_state() -> OptState:
            return adam_init(tuple(image_shape), device)

        def update(image: torch.Tensor, state: AdamState, params, targets):
            return adam_step(
                lambda x: vag(x, params, targets), image, state, lr,
            )

    else:
        msg = f"Unknown optimizer: {optimizer!r}"
        raise ValueError(msg)
    return update, init_state


def build_update_step(
    params: Params,
    targets: Targets,
    image_shape: tuple[int, ...],
    *,
    optimizer: str = "lbfgs",
    lr: float,
    style_w: float,
    content_w: float,
    tv_w: float = 0.0,
    lap_w: float = 0.0,
    lap_pool: int = 4,
    lap_target: torch.Tensor | None = None,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None = None,
    lbfgs_max_iter: int = 1,
    lbfgs_max_eval: int = 1,
    lbfgs_history_size: int = 100,
    lbfgs_history_dtype: str = "float32",
    lbfgs_direction: str = "two-loop",
) -> StepBundle:
    """Build ``update(image, state) -> (image, state, StepAux)``.

    ``image`` is the working ``(1, H, W, 3)`` tensor in (possibly
    normalized) model space. The optimizer state lives on the device of
    the weights, which is the run's device. ``tv_w`` adds the TV term
    (``ops/tv.py``), ``lap_w`` the Laplacian term (``ops/lap.py``)
    against ``lap_target``, ``lap_response(content, lap_pool)``;
    ``style_weights`` weighs each style layer (``models/features.py``).
    The update is :func:`targets_update`'s over :func:`make_objective`,
    with the weights and ``targets`` bound.
    """
    if lap_w and lap_target is None:
        msg = "lap_w > 0 requires a precomputed lap_target response"
        raise ValueError(msg)
    device = next(iter(params.values()))["w9"].device
    loss_fn = make_objective(
        style_w=style_w, content_w=content_w, tv_w=tv_w, lap_w=lap_w,
        lap_pool=lap_pool, style_layers=style_layers,
        content_layers=content_layers, style_weights=style_weights,
    )
    update, init_state = targets_update(
        loss_fn, image_shape, device,
        optimizer=optimizer,
        lr=lr,
        lbfgs_max_iter=lbfgs_max_iter,
        lbfgs_max_eval=lbfgs_max_eval,
        lbfgs_history_size=lbfgs_history_size,
        lbfgs_history_dtype=lbfgs_history_dtype,
        lbfgs_direction=lbfgs_direction,
    )
    bound = (targets, lap_target) if lap_w else targets

    def update_fn(image: torch.Tensor, state: OptState):
        return update(image, state, params, bound)

    return StepBundle(
        update_fn=update_fn,
        opt_state=init_state(),
        chunked_update_fn=chunked(update_fn),
    )


def chunked(update_fn: Callable) -> Callable:
    """``chunked_update_fn(image, state, *extra, k)`` over ``update_fn``.

    A Python loop of ``k`` steps of ``update_fn(image, state, *extra)``
    (``extra`` is empty for :func:`build_update_step`'s update, the
    weights and targets for :func:`targets_update`'s); the metrics are
    stacked along a leading ``k`` axis.
    """

    def chunked_update_fn(image: torch.Tensor, state, *rest):
        *extra, k = rest
        auxes: list[StepAux] = []
        for _ in range(k):
            image, state, aux = update_fn(image, state, *extra)
            auxes.append(aux)
        stacked = StepAux(
            *(
                torch.stack([getattr(a, f) for a in auxes])
                for f in ("loss", "style_score", "content_score", "n_evals")
            ),
        )
        return image, state, stacked

    return chunked_update_fn
