"""The multi-style batch: one content image against S styles.

The port of the JAX package's ``parallel/multistyle.py``. Each style
defines an independent problem with an image of its
own; the S problems run as one stacked step on one card, the style
axis being the batch dimension of every operation: the conv kernel
runs at N = S, each Gram layer is one launch of the batched Gram
kernel for all S images, and the optimizer's state carries a leading
style axis with every decision taken per style. The content targets
and the Laplacian target are the one content's, broadcast across the
styles, never copied. The JAX package's ``MultiStyleBundle`` is the
port's ``engine.step.StepBundle``: each rank holds its own targets,
so the bundle holds the step and its state alone.

Over several cards each rank of a style axis runs this step on its
block of styles (``main.prepare_multi_style``); over a style x space
mesh the same step runs the row-sharded loss
(``parallel.spatial.build_dp_sp_update``).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    AdamState,
    LbfgsState,
    adam_init_batched,
    adam_step_batched,
    lbfgs_init_batched,
    lbfgs_step_batched,
)
from style_transfer_visualizer_tpu_torch.engine.step import (
    HISTORY_DTYPES,
    StepBundle,
    chunked,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    batched_total_loss,
    compute_targets,
    initialize_input,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.lap import lap_loss_per_image
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MIXED,
    PrecisionLike,
)
from style_transfer_visualizer_tpu_torch.ops.tv import tv_loss_per_image
from style_transfer_visualizer_tpu_torch.type_defs import InitMethod


def multi_style_targets(
    params: Params,
    content_img: torch.Tensor,
    style_imgs: Sequence[torch.Tensor],
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    precision: PrecisionLike = MIXED,
) -> Targets:
    """Per-style targets stacked along a leading style axis.

    One style sweep per style (styles may differ in size: a Gram is C x
    C whatever the image), the content sweep once. The content features
    are ``(S, 1, h, w, C)`` views of the one content's: at 4K one
    layer-21 copy would be about 134 MB.
    """
    per_style = [
        compute_targets(
            params, style, content_img, style_layers, (), precision,
        )
        for style in style_imgs
    ]
    content_only = compute_targets(
        params, content_img, content_img, (), content_layers, precision,
    ).content_feats
    n = len(style_imgs)
    return Targets(
        style_grams={
            idx: torch.stack([t.style_grams[idx] for t in per_style])
            for idx in style_layers
        },
        content_feats={
            idx: feat.expand(n, *feat.shape)
            for idx, feat in content_only.items()
        },
    )


def initialize_multi_inputs(
    content_img: torch.Tensor,
    method: InitMethod,
    generator: torch.Generator | None,
    n_styles: int,
) -> torch.Tensor:
    """(S, 1, H, W, 3) starting images, one per style.

    ``"random"`` draws one ``(S, 1, H, W, 3)`` normal from
    ``generator``, so each style starts from its own draw; every other
    method copies the single initializer S times.
    """
    if method == "random":
        if generator is None:
            msg = "random init requires a torch.Generator"
            raise ValueError(msg)
        return torch.randn(
            (n_styles, *content_img.shape), generator=generator,
            dtype=content_img.dtype, device=content_img.device,
        )
    single = initialize_input(content_img, method, generator)
    return single.expand(n_styles, *single.shape).clone()


def build_multi_style_update(
    params: Params,
    targets: Targets,
    image_shape: tuple[int, ...],
    n_styles: int,
    *,
    optimizer: str = "lbfgs",
    lr: float = 1.0,
    style_w: float = 1e5,
    content_w: float = 1.0,
    style_layers: tuple[int, ...] = (),
    content_layers: tuple[int, ...] = (),
    lbfgs_max_iter: int = 1,
    lbfgs_max_eval: int = 1,
    lbfgs_history_size: int = 10,
    lbfgs_history_dtype: str = "float32",
    lbfgs_direction: str = "two-loop",
    tv_w: float = 0.0,
    lap_w: float = 0.0,
    lap_pool: int = 4,
    lap_target: torch.Tensor | None = None,
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = MIXED,
    remat: bool = False,
    loss_fn=None,
    mesh=None,
) -> StepBundle:
    """Build the stacked step of S independent problems.

    ``image_shape`` is one style's image, ``(1, H, W, 3)``; ``targets``
    come from :func:`multi_style_targets`. ``lap_target`` is the
    content's Laplacian response, shared by every style. The bundle's
    ``update_fn(images, state)`` takes ``(S, *image_shape)`` images and
    gives ``(S,)`` metrics; its chunks stack them to ``(k, S)``. The loss of
    each style is the single run's (``engine/step.py``); the backward
    runs once, on their sum, and gives each image its own gradient.
    ``precision`` is the resolved tier; ``remat`` rematerializes the
    feature sweep (``models.features.extract_features``), as the JAX
    package's batch does (it has no banded batch).

    ``loss_fn(params, images, targets) -> ((S,) totals, ((S,) style,
    (S,) content))`` replaces that objective, ``images`` the sweep's
    ``(S * B, H, W, 3)``: the dp x sp step injects the row-sharded one
    so (``parallel.spatial.build_dp_sp_update``), and ``mesh`` is then
    its mesh, ``image_shape`` one style's rows on this rank, and the
    step an ``EagerChunk`` when the row holds a group.
    """
    device = next(iter(params.values()))["w9"].device
    n = 1
    for dim in image_shape:
        n *= int(dim)
    stacked_shape = (n_styles, *image_shape)
    # The feature sweep's batch: one image per style.
    sweep_shape = (n_styles * int(image_shape[0]), *image_shape[1:])
    if loss_fn is None:
        if lap_w and lap_target is None:
            msg = "lap_w > 0 requires a precomputed lap_target response"
            raise ValueError(msg)
        loss_fn = _batched_objective(
            style_w=style_w, content_w=content_w, tv_w=tv_w, lap_w=lap_w,
            lap_pool=lap_pool, lap_target=lap_target,
            style_layers=tuple(style_layers),
            content_layers=tuple(content_layers),
            style_weights=style_weights, precision=precision, remat=remat,
        )

    def vag(x_in: torch.Tensor):
        with torch.enable_grad():
            x = x_in.detach().requires_grad_(True)
            total, (style, content) = loss_fn(
                params, x.reshape(sweep_shape), targets,
            )
            (grad,) = torch.autograd.grad(total.sum(), x)
        return (total.detach(), (style.detach(), content.detach())), grad

    if optimizer == "lbfgs":
        try:
            history_dtype = HISTORY_DTYPES[lbfgs_history_dtype]
        except KeyError:
            msg = f"Unknown L-BFGS history dtype: {lbfgs_history_dtype!r}"
            raise ValueError(msg) from None
        opt_state = lbfgs_init_batched(
            n_styles, n, lbfgs_history_size, device, history_dtype,
        )

        def update_fn(images: torch.Tensor, state: LbfgsState):
            new_flat, new_state, aux = lbfgs_step_batched(
                vag, images.reshape(n_styles, n), state, lr,
                max_iter=lbfgs_max_iter,
                max_eval=lbfgs_max_eval,
                direction_method=lbfgs_direction,
                mesh=mesh,
            )
            return new_flat.reshape(stacked_shape), new_state, aux

    elif optimizer == "adam":
        opt_state = adam_init_batched(stacked_shape, device)

        def update_fn(images: torch.Tensor, state: AdamState):
            return adam_step_batched(vag, images, state, lr)

    else:
        msg = f"Unknown optimizer: {optimizer!r}"
        raise ValueError(msg)

    return StepBundle(
        update_fn=update_fn,
        opt_state=opt_state,
        chunked_update_fn=chunked(update_fn, mesh),
    )


def _batched_objective(
    *,
    style_w: float,
    content_w: float,
    tv_w: float,
    lap_w: float,
    lap_pool: int,
    lap_target: torch.Tensor | None,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None,
    precision: PrecisionLike,
    remat: bool,
):
    """The batch's objective, ``loss_fn(params, images, targets)``:
    each image's style, content, TV and Laplacian terms, ``(S,)``."""

    def loss_fn(params: Params, img: torch.Tensor, targets: Targets):
        total, (style, content) = batched_total_loss(
            params, img, targets, style_w, content_w,
            style_layers, content_layers, style_weights, precision,
            remat=remat,
        )
        if tv_w:
            total = total + tv_w * tv_loss_per_image(img)
        if lap_w:
            total = total + lap_w * lap_loss_per_image(
                img, lap_target, lap_pool,
            )
        return total, (style, content)

    return loss_fn
