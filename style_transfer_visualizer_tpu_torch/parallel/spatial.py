"""Row-sharded feature extraction and loss over a process mesh.

The port of the JAX package's ``parallel/spatial.py``. Image rows are
split over the ranks of a ``parallel.mesh.Mesh``'s style row, rank r
holding rows ``mesh.rows(h)``. Each 3x3
SAME conv takes one halo row from each neighbour
(:func:`exchange_halos`; the edge ranks get zeros, exactly SAME padding
at the image's border), 2x2 pools stay local because every shard's
height stays even (:func:`validate_shard_divisibility`), and each
style layer's Gram is the sum over the ranks of the shards' raw C x C
partials, clamped and normalized once. Content, TV and Laplacian terms
sum the same way. No rank ever holds a whole feature map.

The halo conv is the port's own conv kernel (``ops/conv3x3.py``) run
SAME on the ``(B, h + 2, W, C)`` halo'd shard, its first and last
output rows cropped: output row j in 1..h reads padded rows j-1..j+1,
all inside the halo'd tensor, so it equals the JAX package's
VALID-in-H conv. Its backward is the same on the gradient with the
flipped stencil (:class:`_HaloConvFn`), as the JAX ``_halo_frozen_bwd``.
Each shard's Gram partials are ``ops/gram.gram_raw_batched`` (the
batched Gram kernel at clamp ``inf``, one raw sum per image, as a
band's partial in ``ops/tiled.py``). On the card
every conv and Gram is a kernel launch; on the CPU their plain
versions run.

The loss is replicated: every rank holds the same scalar. So the
gradient that reaches a rank's partial sum is ``dL/dS`` once, and the
sum's backward passes it through unchanged (:class:`_AllSumFn`), the
transpose the JAX ``psum`` has inside ``shard_map``; PyTorch's
differentiable ``all_reduce`` would sum it again, N times too large.
The halo exchange's backward sends each halo row's gradient back to
the rank that owns the row (the transpose of ``ppermute``).

Every rank must issue the same collectives in the same order, the
backward's included: a rank's graph never drops a collective's output
(the last rank's TV seam is masked with ``torch.where``, not skipped).

The loss is per image (:func:`make_spatial_loss`): a single run is a
batch of one, and the multi-style batch over a style x space mesh
(:func:`build_dp_sp_update`) runs a rank's block of styles as one batch
of images, each style layer one batched launch and one sum over the
row for every image, each style's optimizer decisions reduced over the
row. Styles never communicate during a step.

``Mesh.rows`` and ``Mesh.shard`` take the place of the JAX
``spatial_shardings``: a rank's rows follow from its index and the
mesh's size alone, its styles from its style row
(``Mesh.styles``, ``Mesh.style_block``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.engine.step import StepBundle
from style_transfer_visualizer_tpu_torch.models.arch import (
    CONV,
    POOL,
    RELU,
    VGG19,
    LayerTable,
    layer_table_from_params,
    pools_before_in,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    _resolve_style_weights,
    _weighted,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import conv3x3_apply
from style_transfer_visualizer_tpu_torch.ops.gram import gram_raw_batched
from style_transfer_visualizer_tpu_torch.ops.lap import (
    _avg_pool,
    lap_response,
    laplacian_filter,
)
from style_transfer_visualizer_tpu_torch.ops.pool import maxpool_2x2, relu
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MIXED,
    PrecisionLike,
    conv_bwd_precision,
    conv_precision,
    kernel_mode,
)
from style_transfer_visualizer_tpu_torch.parallel.mesh import Mesh
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
)

LAYER_TABLE = VGG19.layer_table

#: The ``content_feats`` key under which the padded Laplacian target
#: (:func:`padded_lap_target`) rides with the content features: it
#: row-shards as they do. -1 is no layer index.
LAP_RESPONSE_KEY = -1


def validate_shard_divisibility(
    global_h: int,
    n_space: int,
    taps: tuple[int, ...],
    table: LayerTable = LAYER_TABLE,
) -> None:
    """Require per-shard heights to stay even across every pool crossed.

    A shard whose height goes odd at a pool would drop a row, unlike
    the whole image, so it is refused up front. ``table`` selects the
    architecture's layer layout (VGG19 by default).
    """
    if not taps:
        return
    max_pools = max(pools_before_in(table, idx) for idx in taps)
    required = n_space * (2**max_pools)
    if global_h % required != 0:
        msg = (
            f"Spatial sharding requires the image height ({global_h}) to "
            f"be divisible by n_space * 2^pools = {n_space} * "
            f"{2**max_pools} = {required} so per-shard heights stay even "
            f"across every pool before the deepest tap."
        )
        raise ValueError(msg)


def validate_lap_shard_divisibility(
    global_h: int,
    n_space: int,
    pool: int,
) -> None:
    """Require per-shard heights to pool evenly for the sharded lap term.

    Each shard's height must be a multiple of ``pool`` so the pooling
    windows are the whole image's, and the pooled image needs 3 rows
    globally and 1 per shard for the stencil.
    """
    shard_h = global_h // n_space
    if shard_h % pool != 0:
        msg = (
            f"--lap-w under --spatial-shards requires the per-shard "
            f"height ({global_h}/{n_space} = {shard_h}) to be divisible "
            f"by lap_pool={pool} so pooling windows align with the "
            "whole-image term; resize the input or adjust --lap-pool."
        )
        raise ValueError(msg)
    pooled_h = global_h // pool
    if pooled_h < 3 or pooled_h // n_space < 1:  # noqa: PLR2004
        msg = (
            f"lap_pool={pool} over {n_space} row shards leaves "
            f"{pooled_h} pooled rows ({pooled_h // n_space} per shard) "
            "— the 3x3 Laplacian stencil needs at least 3 global rows "
            "and 1 per shard; lower --lap-pool or --spatial-shards."
        )
        raise ValueError(msg)


def padded_lap_target(content_img: torch.Tensor, pool: int) -> torch.Tensor:
    """The whole image's Laplacian target, one zero row on each side.

    ``ops.lap.lap_response`` is VALID in H, its rows the pooled center
    rows ``1 .. hp-2``; the padding indexes it by pooled center row
    (``hp`` rows), as :func:`sharded_lap` makes its responses, so it
    row-shards like a content feature map. The zero rows sit only
    where the sharded term masks.
    """
    resp = lap_response(content_img, pool)
    return F.pad(resp, (0, 0, 0, 0, 1, 1)).detach()


def _with_halos(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` with its neighbours' edge rows on top and below (zeros at
    the image's edges): ``(B, h + 2, W, C)``, no autograd.

    Rank r puts its first and last rows in slot r of a zero buffer of
    ``(N, 2, B, W, C)``; one byte-sum over the ranks hands every rank
    every slot, bit for bit.
    """
    b, _, w, c = x.shape
    zero = x.new_zeros((b, 1, w, c))
    if mesh.size == 1:
        return torch.cat([zero, x, zero], dim=1)
    r = mesh.index
    buf = x.new_zeros((mesh.size, 2, b, w, c))
    buf[r, 0] = x[:, 0]
    buf[r, 1] = x[:, -1]
    mesh.sum_bytes(buf)
    top = buf[r - 1, 1][:, None] if r > 0 else zero
    bottom = buf[r + 1, 0][:, None] if r < mesh.size - 1 else zero
    return torch.cat([top, x, bottom], dim=1)


def _halo_grad(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The gradient of ``x`` from that of :func:`_with_halos` (x): the
    inner rows' own, plus what the neighbours' halo rows received.

    A halo row is a neighbour's edge row, so its gradient goes back to
    that neighbour and adds to the row (the transpose of the exchange).
    """
    dx = g[:, 1:-1].clone()
    if mesh.size == 1:
        return dx
    r = mesh.index
    b, _, w, c = g.shape
    buf = g.new_zeros((mesh.size, 2, b, w, c))
    buf[r, 0] = g[:, 0]    # belongs to rank r - 1's last row
    buf[r, 1] = g[:, -1]   # belongs to rank r + 1's first row
    mesh.sum_bytes(buf)
    if r < mesh.size - 1:
        dx[:, -1] += buf[r + 1, 0]
    if r > 0:
        dx[:, 0] += buf[r - 1, 1]
    return dx


class _ExchangeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        """Concatenate the neighbours' halo rows onto ``x``."""
        ctx.mesh = mesh
        return _with_halos(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        """Send each halo row's gradient back to its owner."""
        return _halo_grad(g.contiguous(), ctx.mesh), None


def exchange_halos(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(B, h, W, C)`` -> ``(B, h + 2, W, C)``: one halo row from each
    mesh neighbour (zeros at the image's edges), differentiable."""
    return _ExchangeFn.apply(x, mesh)


class _AllSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        """The sum over the ranks (a new tensor)."""
        return mesh.all_sum(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        """The identity: the loss is replicated, so each rank's
        partial receives ``dL/dS`` once."""
        return g, None


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, with the replicated-loss backward
    (the JAX ``psum`` inside ``shard_map``)."""
    if mesh.size == 1:
        return t
    return _AllSumFn.apply(t, mesh)


class _HaloConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layer, mesh, mode, bwd_mode):
        """The rows of the global SAME conv + bias: halo exchange, the
        conv on the halo'd shard, crop."""
        padded = _with_halos(x.contiguous(), mesh)
        out = conv3x3_apply(
            padded, layer["w9"], (layer["wk_hi"], layer["wk_lo"]),
            layer["b"], False, None, mode,
        )
        ctx.layer = layer
        ctx.mesh = mesh
        ctx.bwd_mode = bwd_mode
        return out[:, 1:-1].contiguous()

    @staticmethod
    def backward(ctx, g):
        """The global SAME conv's adjoint, sharded the same way: the
        flipped stencil's halo conv of ``g``, in the backward's mode.
        The weights are frozen: no weight gradient."""
        layer = ctx.layer
        padded = _with_halos(g.contiguous(), ctx.mesh)
        dx = conv3x3_apply(
            padded, layer["w9_flip"], (layer["wkf_hi"], layer["wkf_lo"]),
            None, False, None, ctx.bwd_mode,
        )
        return dx[:, 1:-1].contiguous(), None, None, None, None


def halo_conv(
    x: torch.Tensor,
    layer: dict[str, torch.Tensor],
    idx: int,
    mesh: Mesh,
    precision: PrecisionLike = MIXED,
) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias of layer ``idx`` over row-sharded
    activations, at that layer's forward and backward modes."""
    return _HaloConvFn.apply(
        x, layer, mesh,
        kernel_mode(conv_precision(precision, idx)),
        kernel_mode(conv_bwd_precision(precision, idx)),
    )


def sharded_extract_features(
    params: Params,
    x: torch.Tensor,
    taps: tuple[int, ...],
    mesh: Mesh,
    precision: PrecisionLike = MIXED,
) -> dict[int, torch.Tensor]:
    """Each rank's rows of the activation at every tap.

    The ReLU runs after conv + bias, as in the JAX package: a fused
    ReLU's backward mask would be the conv's own output, and a halo'd
    gradient's halo rows have no local output to mask them with.
    """
    if not taps:
        return {}
    table = layer_table_from_params(params)
    tap_set = frozenset(taps)
    last = max(taps)
    acts: dict[int, torch.Tensor] = {}
    for idx, (kind, _, _) in enumerate(table[: last + 1]):
        if kind == CONV:
            x = halo_conv(x, params[idx], idx, mesh, precision)
        elif kind == RELU:
            x = relu(x)
        elif kind == POOL:
            x = maxpool_2x2(x)
        if idx in tap_set:
            acts[idx] = x
    return acts


def sharded_grams(
    features: torch.Tensor,
    layer_pixels: int,
    mesh: Mesh,
    precision: PrecisionLike = MIXED,
) -> torch.Tensor:
    """Each image's global Gram from row-sharded features, ``(N, C,
    C)`` for the rows of N images: the ranks' raw partials (one
    batched launch) summed over the row in one collective, then
    clamped, then divided by ``layer_pixels`` (H * W of one image's
    whole map) times C, the whole image's order."""
    c = features.shape[-1]
    raw = psum(gram_raw_batched(features.contiguous(), precision), mesh)
    return torch.clamp(raw, max=GRAM_MATRIX_CLAMP_MAX) / (layer_pixels * c)


def sharded_tv(
    x: torch.Tensor,
    global_shape: tuple[int, ...],
    mesh: Mesh,
) -> torch.Tensor:
    """``ops.tv.tv_loss`` of each whole image from each rank's rows:
    ``(N,)`` for the ``(N, h, W, C)`` rows of N images of
    ``global_shape`` ``(1, H, W, C)`` each.

    Horizontal differences are local; each rank adds the seam between
    its last row and the next rank's first, masked on the last rank.
    Each image's two sums add over the ranks in one collective and
    divide by the whole image's counts.
    """
    _, gh, gw, c = (int(d) for d in global_shape)
    xf = x.float()
    dims = (1, 2, 3)
    local_dx = torch.sum(torch.square(xf[:, :, 1:] - xf[:, :, :-1]), dims)
    local_dy = torch.sum(torch.square(xf[:, 1:] - xf[:, :-1]), dims)
    if mesh.size > 1:
        below_top = exchange_halos(xf, mesh)[:, -1:]
        seam = torch.sum(torch.square(below_top - xf[:, -1:]), dims)
        interior = torch.full(
            (), mesh.index < mesh.size - 1, dtype=torch.bool,
            device=x.device,
        )
        local_dy = local_dy + torch.where(interior, seam, 0.0)
    sum_dy, sum_dx = psum(torch.stack([local_dy, local_dx]), mesh)
    return sum_dy / ((gh - 1) * gw * c) + sum_dx / (gh * (gw - 1) * c)


def sharded_lap(
    x: torch.Tensor,
    target_pad: torch.Tensor,
    global_shape: tuple[int, ...],
    mesh: Mesh,
    *,
    pool: int = 4,
) -> torch.Tensor:
    """``ops.lap.lap_loss`` of each whole image from each rank's rows:
    ``(N,)``, as :func:`sharded_tv`.

    Each rank mean-pools its rows (exact: shard heights divide
    ``pool``), takes a pooled halo row from each neighbour and runs the
    stencil VALID over the halo'd block, one response per local pooled
    row. Pooled rows 0 and ``hp - 1``, whose stencil leaves the image,
    are masked; the sums add over the ranks and divide by the whole
    image's response count. ``target_pad`` is this rank's rows of
    :func:`padded_lap_target`, one content's for every image.
    """
    _, gh, gw, c = (int(d) for d in global_shape)
    hp, wp = gh // pool, gw // pool
    xp = _avg_pool(x.float(), pool)
    local_hp = int(xp.shape[1])
    resp = laplacian_filter(exchange_halos(xp, mesh))
    diff = resp - target_pad.float()
    global_row = mesh.index * local_hp + torch.arange(
        local_hp, device=x.device,
    )
    valid = ((global_row >= 1) & (global_row <= hp - 2)).to(diff.dtype)
    masked = torch.square(diff) * valid[None, :, None, None]
    total = psum(torch.sum(masked, (1, 2, 3)), mesh)
    return total / ((hp - 2) * (wp - 2) * c)


def _sharded_loss(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    mesh: Mesh,
    *,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    global_shape: tuple[int, ...],
    precision: PrecisionLike,
    tv_w: float,
    style_weights: tuple[float, ...] | None,
    lap_w: float,
    lap_pool: int,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One rank's evaluation of each image's replicated ``(total,
    (style, content))``, each ``(N,)``; TV and Laplacian add to the
    total only.

    ``x`` is the rows of N images of ``global_shape`` ``(1, H, W, 3)``;
    ``targets`` holds ``(N, C, C)`` Grams and ``(N, 1, h, w, C)`` rows
    of the content features (a broadcast view serves). Each style
    layer is one batched launch of the raw partials and one sum over
    the ranks for all N images; each content layer, the TV and the
    Laplacian term one sum each.
    """
    weight_of = dict(zip(
        style_layers, _resolve_style_weights(style_weights, style_layers),
        strict=True,
    ))
    table = layer_table_from_params(params)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    acts = sharded_extract_features(params, x, taps, mesh, precision)
    zero = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    style_score = content_score = zero
    _, gh, gw, _ = global_shape
    for idx in taps:
        scale = 2 ** pools_before_in(table, idx)
        layer_h, layer_w = gh // scale, gw // scale
        act = acts[idx]
        c = act.shape[-1]
        if idx in style_layers:
            gram = sharded_grams(act, layer_h * layer_w, mesh, precision)
            style_score = style_score + _weighted(
                weight_of[idx],
                torch.mean(
                    torch.square(gram - targets.style_grams[idx]), (1, 2),
                ),
            )
        if idx in content_layers:
            local_sq = torch.sum(
                torch.square(act - targets.content_feats[idx][:, 0]),
                (1, 2, 3),
            )
            content_score = content_score + psum(local_sq, mesh) / (
                layer_h * layer_w * c
            )
    total = style_w * style_score + content_w * content_score
    if tv_w:
        total = total + tv_w * sharded_tv(x, global_shape, mesh)
    if lap_w:
        total = total + lap_w * sharded_lap(
            x, targets.content_feats[LAP_RESPONSE_KEY][:, 0], global_shape,
            mesh, pool=lap_pool,
        )
    return total, (style_score, content_score)


def make_spatial_loss(
    mesh: Mesh,
    global_shape: tuple[int, ...],
    *,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    precision: PrecisionLike = MIXED,
    tv_w: float = 0.0,
    table: LayerTable = LAYER_TABLE,
    style_weights: tuple[float, ...] | None = None,
    lap_w: float = 0.0,
    lap_pool: int = 4,
    per_image: bool = False,
):
    """The row-sharded loss with the whole image's contract.

    Returns ``loss_fn(params, image, targets) -> (total, (style_score,
    content_score))``, every value replicated, for
    ``engine.step.build_update_step(loss_fn=...)``: ``image`` is this
    rank's rows of the ``global_shape`` image, ``targets`` the
    replicated style Grams and this rank's rows of the content features
    (:func:`compute_sharded_targets`), with the rows of
    :func:`padded_lap_target` under ``LAP_RESPONSE_KEY`` when
    ``lap_w`` is set. The divisibility checks run here, against
    ``table``.

    ``per_image=True`` gives the batch's form (:func:`build_dp_sp_update`):
    ``image`` is the rows of N images of ``global_shape`` each, the
    targets carry a leading axis of N (``(N, C, C)`` Grams, ``(N, 1,
    h, w, C)`` feature rows), and every value is ``(N,)``.
    """
    validate_shard_divisibility(
        int(global_shape[1]), mesh.size,
        tuple(set(style_layers) | set(content_layers)), table,
    )
    if lap_w:
        validate_lap_shard_divisibility(
            int(global_shape[1]), mesh.size, lap_pool,
        )
    settings = {
        "style_w": style_w, "content_w": content_w,
        "style_layers": tuple(style_layers),
        "content_layers": tuple(content_layers),
        "global_shape": tuple(int(d) for d in global_shape),
        "precision": precision, "tv_w": tv_w,
        "style_weights": style_weights, "lap_w": lap_w,
        "lap_pool": lap_pool,
    }
    if per_image:
        def loss_fn(params: Params, image: torch.Tensor, targets: Targets):
            return _sharded_loss(params, image, targets, mesh, **settings)

        return loss_fn

    def single_loss_fn(params: Params, image: torch.Tensor, targets: Targets):
        # The whole image is a batch of one.
        one = Targets(
            style_grams={k: g[None] for k, g in targets.style_grams.items()},
            content_feats={
                k: f[None] for k, f in targets.content_feats.items()
            },
        )
        total, (style, content) = _sharded_loss(
            params, image, one, mesh, **settings,
        )
        return total[0], (style[0], content[0])

    return single_loss_fn


def build_dp_sp_update(
    mesh: Mesh,
    params: Params,
    stacked_targets: Targets,
    image_shape: tuple[int, ...],
    n_styles: int,
    *,
    optimizer: str = "adam",
    lr: float = 0.05,
    style_w: float = 1e4,
    content_w: float = 1.0,
    style_layers: tuple[int, ...] = (0, 5),
    content_layers: tuple[int, ...] = (2,),
    precision: PrecisionLike = MIXED,
    lbfgs_max_iter: int = 1,
    lbfgs_max_eval: int = 1,
    lbfgs_history_size: int = 100,
    lbfgs_history_dtype: str = "float32",
    lbfgs_direction: str = "two-loop",
    tv_w: float = 0.0,
    style_weights: tuple[float, ...] | None = None,
    lap_w: float = 0.0,
    lap_pool: int = 4,
) -> StepBundle:
    """The step of an ``n_styles`` batch over both mesh axes (dp x sp).

    The JAX package's ``build_dp_sp_update``: this rank holds styles
    ``mesh.styles(n_styles)`` and, of each, rows ``mesh.rows(H)`` of
    the ``image_shape`` ``(1, H, W, 3)`` image; its update takes the
    ``(S_local, 1, h, W, 3)`` block and gives ``(S_local,)`` metrics.
    ``stacked_targets`` are the block's: ``(S_local, C, C)`` whole
    Grams and ``(S_local, 1, h, w, C)`` rows of the content features
    (a broadcast of one content's serves), with the padded Laplacian
    target's rows under ``LAP_RESPONSE_KEY`` when ``lap_w`` is set.

    The block goes through the sharded features as one batch of
    S_local images: halo convs over the row, each style layer's raw
    partials in one batched launch and summed over the row in one
    collective (:func:`make_spatial_loss` with ``per_image``). Adam is
    shard-local, with no gradient collective; L-BFGS reduces each
    style's scalars over the row (``lbfgs_step_batched(mesh=)``).
    Styles never communicate during a step. No remat: a shard is the
    memory cut. Returns the port's ``StepBundle``; the step is eager
    when the row holds a group.
    """
    if n_styles % mesh.style_size:
        msg = (
            f"{n_styles} styles do not split over a style axis of "
            f"{mesh.style_size}"
        )
        raise ValueError(msg)
    b, h, w, c = (int(d) for d in image_shape)
    loss_fn = make_spatial_loss(
        mesh, (b, h, w, c), style_w=style_w, content_w=content_w,
        style_layers=tuple(style_layers),
        content_layers=tuple(content_layers), precision=precision,
        tv_w=tv_w, table=layer_table_from_params(params),
        style_weights=style_weights, lap_w=lap_w, lap_pool=lap_pool,
        per_image=True,
    )
    return build_multi_style_update(
        params, stacked_targets, (b, h // mesh.size, w, c),
        n_styles // mesh.style_size,
        optimizer=optimizer, lr=lr,
        lbfgs_max_iter=lbfgs_max_iter, lbfgs_max_eval=lbfgs_max_eval,
        lbfgs_history_size=lbfgs_history_size,
        lbfgs_history_dtype=lbfgs_history_dtype,
        lbfgs_direction=lbfgs_direction, precision=precision,
        loss_fn=loss_fn, mesh=mesh,
    )


@torch.no_grad()
def compute_sharded_targets(
    mesh: Mesh,
    params: Params,
    style_rows: torch.Tensor,
    content_rows: torch.Tensor,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    *,
    precision: PrecisionLike = MIXED,
) -> Targets:
    """Targets from each rank's rows of one style image and of the
    content image: the style Grams summed over the ranks (replicated),
    the content features left in rows."""
    taps = tuple(set(style_layers) | set(content_layers))
    table = layer_table_from_params(params)
    for rows in (content_rows, style_rows):
        validate_shard_divisibility(
            int(rows.shape[1]) * mesh.size, mesh.size, taps, table,
        )
    style_acts = sharded_extract_features(
        params, style_rows, tuple(style_layers), mesh, precision,
    )
    content_acts = sharded_extract_features(
        params, content_rows, tuple(content_layers), mesh, precision,
    )
    _, sh, sw, _ = style_rows.shape
    grams = {}
    for idx, act in style_acts.items():
        scale = 2 ** pools_before_in(table, idx)
        grams[idx] = sharded_grams(
            act, (sh * mesh.size // scale) * (sw // scale), mesh, precision,
        )[0]
    return Targets(style_grams=grams, content_feats=dict(content_acts))


#: The optimizer state's fields that hold image rows, and the axis of
#: their rows: the L-BFGS vectors are the flattened image (one shard's
#: rows are one block of it), Adam's moments the image's own NHWC shape
#: (rows third from the end: axis 1 of a single run's ``(1, H, W, 3)``,
#: axis 2 of the batch's ``(S, 1, H, W, 3)``).
ROW_FIELDS = {
    "s_hist": -1, "y_hist": -1, "prev_grad": -1, "direction": -1,
    "mu": -3, "nu": -3,
}


def gather_state(mesh: Mesh, state):
    """The whole run's optimizer state from each rank's, on every rank
    (a checkpoint's layout: the whole image's, and with a style axis
    the whole batch's, every field's styles on axis 0)."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name in ROW_FIELDS:
            value = mesh.gather(value, ROW_FIELDS[f.name])
        out[f.name] = mesh.gather_styles(value)
    return type(state)(**out)


def shard_state(mesh: Mesh, state):
    """This rank's part of a whole optimizer state, on its device."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if mesh.style_size > 1:
            value = mesh.style_block(value)
        out[f.name] = (
            mesh.shard(value, ROW_FIELDS[f.name]) if f.name in ROW_FIELDS
            else value.to(mesh.device)
        )
    return type(state)(**out)


def whole_state_like(mesh: Mesh, state):
    """A state of the whole run's shapes and dtypes, on the ``meta``
    device: the template ``runtime.checkpoint.load_checkpoint`` reads
    a sharded run's whole checkpoint against."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        shape = list(value.shape)
        if f.name in ROW_FIELDS:
            shape[ROW_FIELDS[f.name]] *= mesh.size
        if mesh.style_size > 1:
            shape[0] *= mesh.style_size
        out[f.name] = torch.empty(shape, dtype=value.dtype, device="meta")
    return type(state)(**out)
