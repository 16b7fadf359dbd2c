"""Builds the per-step update (L-BFGS or Adam) for a style-transfer run.

The port of the JAX package's ``engine/step.py``: the loss and its
gradient come from autograd through the feature path (whose convs and
Grams run the CUDA kernels on the card), plus the optional TV and
Laplacian terms on the image, and the optimizer update follows.
Metrics stay device tensors; the caller decides when to read them.

PyTorch runs eagerly, so there is no jit. The JAX package's k-step
dispatch (``make_chunked_update``, one ``lax.scan`` executable) is
:class:`GraphedChunk` here: on the card each step is one replay of a
CUDA graph captured from the step, so the host issues one launch where
the eager step issues hundreds; on the CPU it is a Python loop of the
eager step.

:func:`targets_update` is the update with its weights and targets as
arguments of every call (the sequence, the blend sweep and the
regional run build on it, through ``sequence.build_targets_update``);
:func:`build_update_step` binds one set of targets to it, so both run
the same arithmetic.

A row-sharded step (``parallel/spatial.py``: ``loss_fn`` and ``mesh``
given) dispatches eagerly, by design: its halo exchanges and sums are
collectives of a process group, which a CUDA graph cannot hold under
gloo, and NCCL under capture cannot be tested on one card.
:func:`chunked` gives such a step an :class:`EagerChunk` (the same
chunks, each step issued from the host), and :class:`GraphedChunk`
refuses it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections.abc import Callable, Iterator
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
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MIXED,
    PrecisionLike,
)
from style_transfer_visualizer_tpu_torch.ops.tiled import tiled_total_loss
from style_transfer_visualizer_tpu_torch.ops.tv import tv_loss
from style_transfer_visualizer_tpu_torch.utils.trace import span, spanned

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
    the per-step ``StepAux`` fields stacked along a leading ``k`` axis
    (a :class:`GraphedChunk`: CUDA-graph replays on the card).
    ``update_fn`` is the eager step.
    """

    update_fn: UpdateFn
    opt_state: OptState
    chunked_update_fn: GraphedChunk


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
    precision: PrecisionLike = MIXED,
    remat: bool = False,
    tile_rows: int = 0,
) -> LossFn:
    """The style + content objective, plus the optional TV and Laplacian
    terms, as ``loss_fn(params, image, targets)``.

    ``targets`` is a ``Targets``; with ``lap_w`` set it is the pair
    ``(Targets, lap_target)``, the Laplacian response
    (``ops.lap.lap_response``) the image is held to. ``precision`` is
    the resolved tier (``ops.precision.resolve_precision``): a run's
    tier is fixed, so a captured step (:class:`GraphedChunk`) holds its
    kernels' modes. ``tile_rows > 0`` evaluates the style and content
    terms band by band (``ops.tiled.tiled_total_loss``); the TV and
    Laplacian terms touch only the image and stay whole-image terms
    outside the bands. Otherwise ``remat`` rematerializes the feature
    sweep (``models.features.extract_features``).
    """
    style_layers = tuple(style_layers)
    content_layers = tuple(content_layers)

    def loss_fn(params: Params, img: torch.Tensor, targets):
        lap_target = None
        if lap_w:
            targets, lap_target = targets
        if tile_rows > 0:
            total, aux = tiled_total_loss(
                params, img, targets, style_w, content_w,
                style_layers, content_layers, tile_rows, precision,
                style_weights,
            )
        else:
            total, aux = total_loss(
                params, img, targets, style_w, content_w,
                style_layers, content_layers, style_weights, precision,
                remat=remat,
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
    mesh=None,
) -> tuple[Callable, Callable[[], OptState]]:
    """``(update, init_state)`` for an objective whose targets are an
    argument.

    ``update(image, state, params, targets) -> (image, state,
    StepAux)`` takes the weights and the targets on every call, so one
    update serves any number of target sets (the frames of a sequence,
    the mixtures of a blend sweep). ``init_state()`` makes a fresh
    optimizer state on ``device``; ``init_state(state)`` resets
    ``state`` to it in place and returns it, so a pipeline that restarts
    the optimizer every frame keeps one state (the tensors a captured
    step reads). The gradient is autograd's through ``loss_fn(params,
    image, targets)``. With ``mesh`` (a ``parallel.mesh.Mesh``) the
    image is one rank's rows and ``loss_fn`` the replicated sharded
    loss; the optimizer reduces over the ranks.
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

        def init_state(reuse: OptState | None = None) -> OptState:
            if reuse is not None:
                return _reset_in_place(reuse)
            return lbfgs_init(n, lbfgs_history_size, device, history_dtype)

        def update(image: torch.Tensor, state: LbfgsState, params, targets):
            new_flat, new_state, aux = lbfgs_step(
                lambda x: vag(x, params, targets), image.reshape(n), state,
                lr,
                max_iter=lbfgs_max_iter,
                max_eval=lbfgs_max_eval,
                direction_method=lbfgs_direction,
                mesh=mesh,
            )
            return new_flat.reshape(image_shape), new_state, aux

    elif optimizer == "adam":
        # The moments carry the image's own shape: no flatten per step.
        def init_state(reuse: OptState | None = None) -> OptState:
            if reuse is not None:
                return _reset_in_place(reuse)
            return adam_init(tuple(image_shape), device)

        def update(image: torch.Tensor, state: AdamState, params, targets):
            return adam_step(
                lambda x: vag(x, params, targets), image, state, lr,
            )

    else:
        msg = f"Unknown optimizer: {optimizer!r}"
        raise ValueError(msg)
    return update, init_state


def _reset_in_place(state: OptState) -> OptState:
    """``state`` set to its optimizer's initial values, in place.

    Every field starts at 0 but L-BFGS's ``h_diag``, at 1
    (``lbfgs_init``, ``adam_init``).
    """
    for f in _state_fields(state):
        getattr(state, f).zero_()
    if isinstance(state, LbfgsState):
        state.h_diag.fill_(1.0)
    return state


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
    precision: PrecisionLike = MIXED,
    remat: bool = False,
    tile_rows: int = 0,
    loss_fn: LossFn | None = None,
    mesh=None,
) -> StepBundle:
    """Build ``update(image, state) -> (image, state, StepAux)``.

    ``image`` is the working ``(1, H, W, 3)`` tensor in (possibly
    normalized) model space. The optimizer state lives on the device of
    the weights, which is the run's device. ``tv_w`` adds the TV term
    (``ops/tv.py``), ``lap_w`` the Laplacian term (``ops/lap.py``)
    against ``lap_target``, ``lap_response(content, lap_pool)``;
    ``style_weights`` weighs each style layer (``models/features.py``);
    ``precision`` is the resolved tier; ``remat`` and ``tile_rows``
    (``> 0``: banded evaluation) as in :func:`make_objective`. The
    update is :func:`targets_update`'s over :func:`make_objective`,
    with the weights and ``targets`` bound. ``loss_fn(params, image,
    targets)`` replaces that objective (the JAX package injects the
    row-sharded loss so, ``parallel.spatial.make_spatial_loss``, whose
    targets carry its own terms); ``mesh`` is then its mesh, ``image``
    this rank's rows, and the step is an :class:`EagerChunk`.
    """
    device = next(iter(params.values()))["w9"].device
    if loss_fn is None:
        if lap_w and lap_target is None:
            msg = "lap_w > 0 requires a precomputed lap_target response"
            raise ValueError(msg)
        loss_fn = make_objective(
            style_w=style_w, content_w=content_w, tv_w=tv_w, lap_w=lap_w,
            lap_pool=lap_pool, style_layers=style_layers,
            content_layers=content_layers, style_weights=style_weights,
            precision=precision, remat=remat, tile_rows=tile_rows,
        )
        bound = (targets, lap_target) if lap_w else targets
    else:
        bound = targets
    update, init_state = targets_update(
        loss_fn, image_shape, device,
        optimizer=optimizer,
        lr=lr,
        lbfgs_max_iter=lbfgs_max_iter,
        lbfgs_max_eval=lbfgs_max_eval,
        lbfgs_history_size=lbfgs_history_size,
        lbfgs_history_dtype=lbfgs_history_dtype,
        lbfgs_direction=lbfgs_direction,
        mesh=mesh,
    )

    def update_fn(image: torch.Tensor, state: OptState):
        return update(image, state, params, bound)

    return StepBundle(
        update_fn=update_fn,
        opt_state=init_state(),
        chunked_update_fn=chunked(update_fn, mesh),
    )


def _holds_group(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def chunked(update_fn: Callable, mesh=None) -> GraphedChunk:
    """``chunked_update_fn(image, state, *extra, k)`` over ``update_fn``.

    ``k`` steps of ``update_fn(image, state, *extra)`` (``extra`` is
    empty for :func:`build_update_step`'s update, the weights and
    targets for :func:`targets_update`'s), the metrics stacked along a
    leading ``k`` axis: a :class:`GraphedChunk`, or an
    :class:`EagerChunk` when ``mesh`` holds a process group.
    """
    if _holds_group(mesh):
        return EagerChunk(update_fn)
    return GraphedChunk(update_fn)


_AUX_FIELDS = ("loss", "style_score", "content_score", "n_evals")


def _stack_aux(auxes: list[StepAux]) -> StepAux:
    return StepAux(*(
        torch.stack([getattr(a, f) for a in auxes]) for f in _AUX_FIELDS
    ))


def _pack_aux(aux: StepAux) -> torch.Tensor:
    """One step's four metrics in one float64 tensor, ``(4, *shape)``.

    float64 holds every float32 value and every count exactly, so one
    copy a step carries all four out of the graph.
    """
    return torch.stack([getattr(aux, f).double() for f in _AUX_FIELDS])


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [
            leaf for f in dataclasses.fields(tree)
            for leaf in _leaves(getattr(tree, f.name))
        ]
    return [tree]


def _tensor_key(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, t.device)


def _state_fields(state) -> list[str]:
    return [f.name for f in dataclasses.fields(state)]


def refill(held, new):
    """``new``'s tensors in ``held``'s storage; returns ``held``.

    ``held`` None gives a clone of ``new``. A graph captured over
    extra arguments reads them at fixed addresses, so a pipeline that
    changes its targets between dispatches (a sweep's blend, a
    sequence's content) copies each new set into the one it holds.
    Trees of dicts, lists, tuples and dataclasses of tensors, of one
    structure.
    """
    if held is None:
        return _map_tree(lambda t: t.clone(), new)
    for dst, src in zip(_leaves(held), _leaves(new), strict=True):
        if isinstance(dst, torch.Tensor):
            dst.copy_(src)
    return held


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
        })
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


_side_streams: dict[int, torch.cuda.Stream] = {}
_pools: dict[int, object] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every warm-up and capture on ``device`` runs on.

    PyTorch keeps a cuBLAS workspace per stream that ran a product;
    the warm-up makes it, so the capture allocates none.
    """
    index = device.index or 0
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(device)
    return _side_streams[index]


def _pool(device: torch.device):
    """The memory pool every graph on ``device`` captures into.

    A graph's temporaries are free again once its replay ends, so
    graphs that replay one after another on one stream share them;
    each keeps only its own metrics buffer.
    """
    index = device.index or 0
    if index not in _pools:
        with torch.cuda.device(device):
            _pools[index] = torch.cuda.graph_pool_handle()
    return _pools[index]


@dataclass
class _Captured:
    """One captured step: its graph, its static tensors, its key."""

    key: tuple
    extra: tuple
    graph: torch.cuda.CUDAGraph
    image: torch.Tensor
    state: OptState
    packed: torch.Tensor          # the step's metrics, (4, *shape)
    aux_dtypes: tuple[torch.dtype, ...]


@dataclass(frozen=True)
class Dispatch:
    """One CUDA dispatch of a :class:`GraphedChunk`, as :func:`recording`
    keeps it."""

    chunk: int                    # the chunk's serial number
    k: int                        # steps
    done: torch.cuda.Event        # recorded after its last step
    capture_seconds: float | None  # of the capture it made, if any


_recordings: list[list[Dispatch]] = []
_serials = itertools.count()


@contextlib.contextmanager
def recording() -> Iterator[list[Dispatch]]:
    """The list of every CUDA dispatch any :class:`GraphedChunk` makes
    in the block, in order.

    A dispatch's ``done`` event lies on the stream after its last step,
    so the device time between two dispatches' ends is
    ``a.done.elapsed_time(b.done)`` (after a synchronize). Outside a
    block no event is recorded.
    """
    log: list[Dispatch] = []
    _recordings.append(log)
    try:
        yield log
    finally:
        _recordings.remove(log)


class GraphedChunk:
    """``chunk(image, state, *extra, k)``: ``k`` steps, metrics stacked.

    The port of the JAX package's ``make_chunked_update``. On a CPU
    tensor it is a Python loop of ``update_fn(image, state, *extra)``,
    the plain version. On a CUDA tensor every step is a replay of one
    CUDA graph of the step, or the call raises; nothing falls back to
    the eager step:

    - the first dispatch (and the first after the key changes: the
      shapes and dtypes of the image and the state, and which tensors
      the extras are) runs one real step eagerly on a side stream (the
      warm-up, which sizes the kernels' arrival counters and makes
      cuBLAS's workspace), then captures the step once over static
      tensors: the warm-up's image and state, and the extras as given.
      Inside the graph the new image and every new state field are
      copied back into the static ones, so replays chain; the ring,
      updated in place, is static already;
    - a step is then one replay, and its four metrics go by one copy
      into a ``(k, 4, ...)`` buffer of this dispatch, so no returned
      metric is the graph's own output;
    - the returned image and state ARE the static tensors: the next
      replay overwrites them. An image or state passed in that is not
      the static one is copied into it (a pipeline's fresh frame);
      new targets go through :func:`refill` into the tensors captured;
    - the kernels count their own runs on the device, replays
      included (``native.build.LaunchCounter``); nothing here counts;
    - every graph captures into one pool per device
      (``torch.cuda.graph_pool_handle``); a new key releases the
      previous capture, and :meth:`release` (or dropping the object)
      releases the last one.

    ``capture_seconds`` lists the seconds of each capture; inside
    :func:`recording` each dispatch is recorded (:meth:`note`).
    """

    def __init__(self, update_fn: Callable, mesh=None) -> None:
        """Wrap ``update_fn(image, state, *extra) -> (image, state, aux)``.

        ``mesh`` is the step's mesh: one that holds a process group
        raises ``ValueError`` (its collectives are not captured;
        :class:`EagerChunk` runs such a step).
        """
        if _holds_group(mesh):
            msg = (
                "a step that holds a process group is not captured in a "
                "CUDA graph; it dispatches eagerly (EagerChunk)"
            )
            raise ValueError(msg)
        self.update_fn = update_fn
        self._entry: _Captured | None = None
        self.capture_seconds: list[float] = []
        self.serial = next(_serials)

    def loop(self, image: torch.Tensor, state, *rest):
        """The plain version: ``k`` eager steps in a Python loop, on any
        device (the CPU's dispatch, and the card's reference)."""
        *extra, k = rest
        auxes: list[StepAux] = []
        with span("stv.dispatch.eager"):
            for _ in range(k):
                image, state, aux = self.update_fn(image, state, *extra)
                auxes.append(aux)
            return image, state, _stack_aux(auxes)

    def __call__(self, image: torch.Tensor, state, *rest):
        """Run ``k`` (the last argument) steps; ``(image, state, aux)``."""
        if image.device.type == "cpu":
            return self.loop(image, state, *rest)
        *extra, k = rest
        extra = tuple(extra)
        if image.device.type != "cuda":
            msg = f"a step dispatch runs on CUDA or CPU, not {image.device}"
            raise ValueError(msg)
        if k < 1:
            msg = f"a step dispatch runs at least one step, not {k}"
            raise ValueError(msg)
        entry, first = self._ready(image, state, extra)
        buf = torch.empty(
            (k, *entry.packed.shape), dtype=torch.float64,
            device=image.device,
        )
        done = 0
        if first is not None:
            buf[0].copy_(first)
            done = 1
        with span("stv.dispatch.replay"):
            for j in range(done, k):
                entry.graph.replay()
                buf[j].copy_(entry.packed)
        aux = StepAux(*(
            buf[:, i].to(dtype) for i, dtype in enumerate(entry.aux_dtypes)
        ))
        self.note(k, self.capture_seconds[-1] if first is not None else None)
        # A copy of the static state's record: an eager step given it
        # rebinds the record's fields, never the capture's.
        return entry.image, dataclasses.replace(entry.state), aux

    def note(self, k: int, capture_seconds: float | None = None) -> None:
        """Record a dispatch of ``k`` steps just issued on the current
        stream in every open :func:`recording`."""
        if not _recordings:
            return
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        for log in _recordings:
            log.append(Dispatch(self.serial, k, done, capture_seconds))

    def release(self) -> None:
        """Drop the captured graph and its static tensors."""
        self._entry = None

    def _key(self, image: torch.Tensor, state, extra: tuple) -> tuple:
        return (
            _tensor_key(image),
            type(state),
            tuple(
                _tensor_key(getattr(state, f)) for f in _state_fields(state)
            ),
            tuple(
                (id(leaf), _tensor_key(leaf))
                if isinstance(leaf, torch.Tensor) else leaf
                for leaf in _leaves(extra)
            ),
        )

    def _ready(self, image, state, extra: tuple):
        """The capture for these arguments, with the static image and
        state holding them; and the warm-up's packed metrics when this
        call captured (its first step ran then)."""
        entry = self._entry
        if (
            entry is not None
            and image is entry.image
            and type(state) is type(entry.state)
            and all(
                getattr(state, f) is getattr(entry.state, f)
                for f in _state_fields(state)
            )
            and len(extra) == len(entry.extra)
            and all(a is b for a, b in zip(extra, entry.extra, strict=True))
        ):
            return entry, None
        key = self._key(image, state, extra)
        if entry is not None and key == entry.key:
            if image is not entry.image:
                entry.image.copy_(image)
            for f in _state_fields(state):
                src = getattr(state, f)
                dst = getattr(entry.state, f)
                if src is not dst:
                    dst.copy_(src)
            entry.extra = extra
            return entry, None
        self._entry = None
        entry, first = self._capture(key, image, state, extra)
        self._entry = entry
        return entry, first

    @spanned("stv.dispatch.capture")
    def _capture(self, key, image, state, extra):
        device = image.device
        stream = _side_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with span("stv.dispatch.warmup"), torch.cuda.stream(stream):
            # The warm-up: the run's next step, eagerly, on the stream
            # the capture will use.
            img, st, aux = self.update_fn(image, state, *extra)
            if img is image or img.data_ptr() == image.data_ptr():
                img = img.clone()
            first = _pack_aux(aux)
            st = dataclasses.replace(st)
        current.wait_stream(stream)
        for t in (img, first, *(getattr(st, f) for f in _state_fields(st))):
            t.record_stream(current)
        with span("stv.dispatch.graph"):
            # The capture allocates from the graph pool only, and while
            # it captures the allocator cannot hand back the default
            # pool's cached blocks: the warm-up's freed temporaries go
            # back to the card first, so a step that fits once fits its
            # capture too.
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(
                    graph, pool=_pool(device), stream=stream,
                ):
                    new_img, new_st, new_aux = self.update_fn(
                        img, dataclasses.replace(st), *extra,
                    )
                    img.copy_(new_img)
                    for f in _state_fields(st):
                        src = getattr(new_st, f)
                        dst = getattr(st, f)
                        if src is not dst:
                            dst.copy_(src)
                    packed = _pack_aux(new_aux)
            except Exception as exc:
                msg = (
                    "capturing the step in a CUDA graph failed; a CUDA "
                    "step is never run eagerly instead"
                )
                raise RuntimeError(msg) from exc
            self.capture_seconds.append(time.perf_counter() - t0)
        return _Captured(
            key=key, extra=extra, graph=graph, image=img, state=st,
            packed=packed,
            aux_dtypes=tuple(getattr(new_aux, f).dtype for f in _AUX_FIELDS),
        ), first


class EagerChunk(GraphedChunk):
    """``chunk(image, state, *extra, k)``: ``k`` eager steps on any
    device.

    The dispatch of a row-sharded step, whose collectives no graph
    holds: the loop of :meth:`GraphedChunk.loop` on the CPU and on the
    card alike, each CUDA dispatch recorded in an open
    :func:`recording` as a graphed one is.
    """

    def __call__(self, image: torch.Tensor, state, *rest):
        """Run ``k`` (the last argument) steps; ``(image, state, aux)``."""
        out = self.loop(image, state, *rest)
        if image.device.type == "cuda":
            self.note(rest[-1])
        return out
