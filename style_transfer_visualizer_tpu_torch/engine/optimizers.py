"""L-BFGS and Adam for pixel-space optimization, without host syncs.

The port of the JAX package's ``engine/optimizers.py``. Adam
(:func:`adam_step`) has ``torch.optim.Adam``'s defaults with eps outside
the square root, its moments in the image's own shape and its step
count a device int32, so the bias corrections are tensor ops too.

L-BFGS (``torch.optim.LBFGS`` semantics without a line search): one
step runs
up to ``max_iter`` inner iterations bounded by ``max_eval`` function
evaluations; the first-ever iteration uses steepest descent with step
``min(1, 1/|g|_1) * lr``; curvature pairs are kept in a ring of
``history_size`` entries; the direction is the two-loop recursion or
the identical compact (Byrd-Nocedal-Schnabel) form.

The JAX ``while_loop``/``cond`` control flow becomes device-side
``torch.where`` masks over a loop of ``max_iter`` iterations, so a step
never reads a value back to the host (no ``.item()``). The curvature
ring of :class:`LbfgsState` is updated IN PLACE; every other field is
replaced by a new tensor.

With ``mesh`` (a ``parallel.mesh.Mesh`` of N > 1 ranks, the JAX
``axis_name``) the vector ``x`` and every vector of the state are one
rank's rows of the whole image's: each dot product, norm and maximum
that a decision or a step length reads is reduced over the ranks
(:func:`_sums`, :func:`_maxes`; in the compact direction the four ring
products in one collective), so every rank takes the same branches and
the same step. The two-loop direction reduces each of its 2m dots on
its own: correct, and slow over a process group. Adam is elementwise
and needs nothing.

The multi-style batch runs S independent problems in one step
(:func:`lbfgs_step_batched`, :func:`adam_step_batched`): every state
field gains a leading style axis, and every decision (``done``, the
curvature-pair skip, the ring position) is taken per style, as the JAX
package's ``vmap`` of the single step takes it. Over a dp x sp mesh
(``mesh``) the S styles' scalars of one point go over the row in one
collective. The masks and updates
are batched elementwise operations; every reduction over the pixels
(the dots, the direction's ring contractions and solves) runs per
style through the single step's own functions. So each style's step
is, bit for bit, its single step: the shipped fixed-step L-BFGS turns
a rounding difference of 1e-7 into 1e-3 of the loss within a few
steps (``PERF.md``), so anything less would not keep a style's run its
own. It is also the faster choice: cuBLAS's batched kernel for the
ring's ``(m, n) (n, m)`` products, n the pixel count, took 8 times as
long as one product per style on an H100 (22.5 ms against 4 x 0.67 ms
at S = 4, 512x512, m = 100).
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from style_transfer_visualizer_tpu_torch.ops import lbfgs_ring
from style_transfer_visualizer_tpu_torch.utils.trace import span

TOLERANCE_GRAD = 1e-7
TOLERANCE_CHANGE = 1e-9
_CURVATURE_EPS = 1e-10


def _sums(mesh, *parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each part (a scalar, or the batch's ``(S,)`` of them) summed
    over the mesh's ranks, all in one collective.

    Without a mesh (or on one rank) the tensors come back as they are.
    """
    if mesh is None or mesh.size == 1:
        return parts
    packed = mesh.all_sum(torch.stack(parts))
    return tuple(packed.unbind(0))


def _maxes(mesh, *parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each part's maximum over the mesh's ranks, in one collective."""
    if mesh is None or mesh.size == 1:
        return parts
    packed = mesh.all_max(torch.stack(parts))
    return tuple(packed.unbind(0))

# value_and_grad over flattened pixels:
# x (N,) -> ((loss, (style_score, content_score)), grad (N,))
ValueAndGrad = Callable[
    [torch.Tensor],
    tuple[tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]],
          torch.Tensor],
]


@dataclass
class LbfgsState:
    """Persistent L-BFGS state (survives across outer steps).

    The shapes are one problem's; the batched state
    (:func:`lbfgs_init_batched`) puts a style axis of S in front of
    each.
    """

    s_hist: torch.Tensor        # (m, N) parameter deltas, updated in place
    y_hist: torch.Tensor        # (m, N) gradient deltas, updated in place
    rho: torch.Tensor           # (m,) 1/(y.s)
    hist_len: torch.Tensor      # int64, number of valid pairs
    hist_pos: torch.Tensor      # int64, ring insertion slot
    h_diag: torch.Tensor        # f32, initial Hessian scaling
    prev_grad: torch.Tensor     # (N,)
    direction: torch.Tensor     # (N,) last search direction
    step_size: torch.Tensor     # f32, last step length t
    prev_loss: torch.Tensor     # f32
    n_total_iters: torch.Tensor  # int64, across the whole run
    func_evals: torch.Tensor    # int64, across the whole run


@dataclass
class StepAux:
    """Device-side metrics produced by one optimizer step."""

    loss: torch.Tensor           # total loss at the last evaluation
    style_score: torch.Tensor
    content_score: torch.Tensor
    n_evals: torch.Tensor        # evaluations consumed by this step

    def at(self, j: int) -> StepAux:
        """Step ``j`` of a chunk's metrics, stacked along axis 0."""
        return StepAux(
            self.loss[j], self.style_score[j], self.content_score[j],
            self.n_evals[j],
        )


def lbfgs_init(
    n: int,
    history_size: int,
    device: torch.device | str,
    history_dtype: torch.dtype = torch.float32,
) -> LbfgsState:
    """Zero-initialized state for an ``n``-parameter problem on ``device``.

    ``history_dtype`` sets the storage type of the curvature ring only;
    ``rho`` and ``h_diag`` are computed from the unrounded pair and
    every product runs in f32.
    """
    m = history_size

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LbfgsState(
        s_hist=zeros((m, n), history_dtype),
        y_hist=zeros((m, n), history_dtype),
        rho=zeros((m,)),
        hist_len=zeros((), torch.int64),
        hist_pos=zeros((), torch.int64),
        h_diag=torch.ones((), dtype=torch.float32, device=device),
        prev_grad=zeros((n,)),
        direction=zeros((n,)),
        step_size=zeros(()),
        prev_loss=zeros(()),
        n_total_iters=zeros((), torch.int64),
        func_evals=zeros((), torch.int64),
    )


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim device index, without reading it back."""
    return t.index_select(0, i.reshape(1))[0]


def _two_loop(
    grad: torch.Tensor, state: LbfgsState, mesh=None,
) -> torch.Tensor:
    """Two-loop recursion: approximate -H^{-1} g from curvature pairs.

    The ring's valid length is a device value, so both loops walk all
    ``m`` slots and mask the ones past ``hist_len``. With ``mesh``
    each of the 2m dots is summed over the ranks.
    """
    m = state.rho.shape[0]
    num, pos = state.hist_len, state.hist_pos
    slots = torch.arange(m, device=grad.device)
    q = -grad
    alphas = torch.zeros_like(state.rho)
    for i in range(m):  # newest to oldest
        valid = i < num
        j = (pos - 1 - i) % m
        s_j = _row(state.s_hist, j).float()
        (sq,) = _sums(mesh, torch.dot(s_j, q))
        alpha = _row(state.rho, j) * sq
        y_j = _row(state.y_hist, j).float()
        q = torch.where(valid, q - alpha * y_j, q)
        alphas = torch.where(valid & (slots == j), alpha, alphas)
    r = q * state.h_diag
    for i in range(m):  # oldest to newest
        valid = i < num
        j = (pos - num + i) % m
        y_j = _row(state.y_hist, j).float()
        (yr,) = _sums(mesh, torch.dot(y_j, r))
        beta = _row(state.rho, j) * yr
        s_j = _row(state.s_hist, j).float()
        r = torch.where(valid, r + s_j * (_row(alphas, j) - beta), r)
    return r


def _compact_coefficients(
    sums: tuple[torch.Tensor, ...], state: LbfgsState,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The compact direction's ring coefficients, fp32 in slot order.

    From the ring's four products ``sums = (S Y^T, Y Y^T, S g, Y g)``
    (slot order; on a mesh already summed over the ranks): ``(w, u)``
    of ``H g = gamma g + S w - gamma Y u``, with ``u = R^{-1} p`` and
    ``w = R^{-T} ((D + gamma Y^T Y) u - gamma q)`` in time order and
    slots past ``hist_len`` masked.
    """
    sy, yy, p, q = sums
    m = state.rho.shape[0]
    num = state.hist_len
    device = sy.device

    # Time order (oldest pair first); slots past hist_len are masked.
    ar = torch.arange(m, device=device)
    idx = (state.hist_pos - num + ar) % m
    valid = ar < num
    vv = valid[:, None] & valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    sy_t = sy[idx][:, idx]
    yy_t = torch.where(vv, yy[idx][:, idx], zero)
    p_t = torch.where(valid, p[idx], zero)
    q_t = torch.where(valid, q[idx], zero)
    # R_ij = s_i . y_j for i <= j; invalid slots become identity rows.
    r_mat = torch.where(vv, torch.triu(sy_t), zero)
    r_mat = r_mat + torch.diag(torch.where(valid, zero, zero + 1.0))
    d_diag = torch.where(valid, torch.diagonal(sy_t), zero)
    gamma = state.h_diag

    u = torch.linalg.solve_triangular(r_mat, p_t[:, None], upper=True)[:, 0]
    rhs = d_diag * u + gamma * (yy_t @ u) - gamma * q_t
    w = torch.linalg.solve_triangular(
        r_mat.T, rhs[:, None], upper=False,
    )[:, 0]

    # Back to slot order for the final ring combination.
    coeff_s = torch.zeros_like(w).index_copy(0, idx, w)
    coeff_y = torch.zeros_like(u).index_copy(0, idx, u)
    return coeff_s, coeff_y


def _compact_direction(
    grad: torch.Tensor,
    state: LbfgsState,
    mesh=None,
) -> torch.Tensor:
    """Compact-representation direction (Byrd-Nocedal-Schnabel 1994).

    The same -H^{-1} g as :func:`_two_loop`, as ring contractions and
    two m-by-m triangular solves (:func:`_compact_coefficients`). The
    JAX package multiplies the (possibly bf16) ring with f32
    accumulation, ``g`` and the combination coefficients rounded to the
    ring's type first. The two passes over the ring (the four products,
    then the combination) are ``ops/lbfgs_ring.py``'s: on the card with
    a bf16 ring its two kernels, which read the ring as stored;
    otherwise (a CPU tensor, an fp32 ring) its plain versions, which
    upcast the ring to f32 in blocks. With ``mesh`` the four products
    are each rank's partials, summed over the ranks in one collective;
    the small solves then run alike on every rank.
    """
    if lbfgs_ring.on_kernels(grad, state.s_hist):
        products = lbfgs_ring.products_kernel
        combine = lbfgs_ring.combine_kernel
    else:
        products = lbfgs_ring.products_plain
        combine = lbfgs_ring.combine_plain

    # sy[a, b] = s_a . y_b, in slot order.
    sums = products(state.s_hist, state.y_hist, grad)
    if mesh is not None and mesh.size > 1:
        packed = mesh.all_sum(torch.cat([t.reshape(-1) for t in sums]))
        sums = tuple(
            part.reshape(t.shape) for part, t in zip(
                packed.split([t.numel() for t in sums]), sums, strict=True,
            )
        )
    coeff_s, coeff_y = _compact_coefficients(sums, state)
    return combine(
        state.s_hist, state.y_hist, grad, coeff_s, coeff_y, state.h_diag,
    )


_DIRECTION_METHODS = {
    "two-loop": _two_loop,
    "compact": _compact_direction,
}


def _insert_pair(
    st: LbfgsState,
    s: torch.Tensor,
    y: torch.Tensor,
    ys: torch.Tensor,
    yy: torch.Tensor,
    do_insert: torch.Tensor,
) -> None:
    """Masked in-place insertion of the pair (s, y) at ``hist_pos``."""
    m = st.rho.shape[0]
    pos = st.hist_pos
    slot = pos.reshape(1)
    for ring, vec in ((st.s_hist, s), (st.y_hist, y)):
        row = torch.where(do_insert, vec.to(ring.dtype), _row(ring, pos))
        ring.index_copy_(0, slot, row[None])
    st.rho = torch.where(
        (torch.arange(m, device=pos.device) == pos) & do_insert,
        1.0 / ys, st.rho,
    )
    st.hist_pos = torch.where(do_insert, (pos + 1) % m, pos)
    st.hist_len = torch.where(
        do_insert, torch.clamp(st.hist_len + 1, max=m), st.hist_len,
    )
    st.h_diag = torch.where(do_insert, ys / yy, st.h_diag)


def lbfgs_step(
    vag: ValueAndGrad,
    x: torch.Tensor,
    state: LbfgsState,
    lr: float,
    *,
    max_iter: int,
    max_eval: int,
    direction_method: str = "two-loop",
    mesh=None,
) -> tuple[torch.Tensor, LbfgsState, StepAux]:
    """One outer L-BFGS step (torch semantics, fixed-step strategy).

    ``x`` is the flattened parameter vector. Returns the new vector,
    the state (its ring updated in place) and the metrics of the
    *last* function evaluation of the step. With ``mesh`` ``x`` is
    this rank's rows and every reduction runs over the ranks.
    """
    try:
        direction_fn = _DIRECTION_METHODS[direction_method]
    except KeyError:
        msg = f"Unknown L-BFGS direction method: {direction_method!r}"
        raise ValueError(msg) from None
    (loss, (style, content)), grad = vag(x)
    (grad_max,) = _maxes(mesh, grad.abs().max())
    done = grad_max <= TOLERANCE_GRAD
    evals = torch.ones((), dtype=torch.int64, device=x.device)
    st = state

    for n_iter in range(1, max_iter + 1):
        active = ~done
        n_total = st.n_total_iters + 1
        first = n_total == 1

        # Curvature-pair insertion, skipped on the first-ever iteration
        # or when the curvature condition y.s > eps fails.
        y = grad - st.prev_grad
        s = st.direction * st.step_size
        ys, yy = _sums(mesh, torch.dot(y, s), torch.dot(y, y))
        do_insert = active & ~first & (ys > _CURVATURE_EPS)
        _insert_pair(st, s, y, ys, yy, do_insert)

        with span("stv.step.direction"):
            direction = torch.where(
                first, -grad, direction_fn(grad, st, mesh),
            )
        l1, gtd = _sums(mesh, grad.abs().sum(), torch.dot(grad, direction))
        t = torch.where(
            first,
            torch.clamp(1.0 / l1, max=1.0) * lr,
            torch.full((), lr, dtype=torch.float32, device=x.device),
        )
        break_gtd = gtd > -TOLERANCE_CHANGE
        x_new = torch.where(break_gtd, x, x + t * direction)

        # Re-evaluate unless this inner iteration is the last or broke.
        if n_iter < max_iter:
            reeval = active & ~break_gtd
            (l_n, (s_n, c_n)), g_n = vag(x_new)
            loss_n = torch.where(reeval, l_n, loss)
            style_n = torch.where(reeval, s_n, style)
            content_n = torch.where(reeval, c_n, content)
            grad_n = torch.where(reeval, g_n, grad)
        else:
            reeval = torch.zeros((), dtype=torch.bool, device=x.device)
            loss_n, style_n, content_n, grad_n = loss, style, content, grad
        evals_n = evals + reeval.to(evals.dtype)

        grad_n_max, step_max = _maxes(
            mesh, grad_n.abs().max(), (t * direction).abs().max(),
        )
        done_n = (
            break_gtd
            | (evals_n >= max_eval)
            | (grad_n_max <= TOLERANCE_GRAD)
            | (step_max <= TOLERANCE_CHANGE)
            | ((loss_n - loss).abs() < TOLERANCE_CHANGE)
        )

        st.prev_grad = torch.where(active, grad, st.prev_grad)
        st.direction = torch.where(active, direction, st.direction)
        st.step_size = torch.where(active, t, st.step_size)
        st.prev_loss = torch.where(active, loss, st.prev_loss)
        st.n_total_iters = torch.where(active, n_total, st.n_total_iters)
        st.func_evals = st.func_evals + reeval.to(st.func_evals.dtype)

        x = torch.where(active, x_new, x)
        loss = torch.where(active, loss_n, loss)
        style = torch.where(active, style_n, style)
        content = torch.where(active, content_n, content)
        grad = torch.where(active, grad_n, grad)
        evals = torch.where(active, evals_n, evals)
        done = done | done_n

    st.func_evals = st.func_evals + 1
    aux = StepAux(
        loss=loss, style_score=style, content_score=content, n_evals=evals,
    )
    return x, st, aux


_ADAM_B1 = 0.9
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8


@dataclass
class AdamState:
    """Adam moment estimates and the step count, all on the device."""

    mu: torch.Tensor     # first moment, the parameter's shape
    nu: torch.Tensor     # second moment, the parameter's shape
    count: torch.Tensor  # int32, steps taken


def adam_init(
    shape: tuple[int, ...],
    device: torch.device | str,
) -> AdamState:
    """Zero moments for a parameter of ``shape`` on ``device``.

    Adam is elementwise, so the moments keep the image's NHWC shape and
    the step never flattens it.
    """
    return AdamState(
        mu=torch.zeros(shape, dtype=torch.float32, device=device),
        nu=torch.zeros(shape, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _adam_update_math(
    grad: torch.Tensor,
    state: AdamState,
    lr: float,
) -> tuple[torch.Tensor, AdamState]:
    """The update ``delta`` and the new state, with no host read."""
    count = state.count + 1
    mu = _ADAM_B1 * state.mu + (1 - _ADAM_B1) * grad
    nu = _ADAM_B2 * state.nu + (1 - _ADAM_B2) * torch.square(grad)
    steps = count.to(torch.float32)
    mu_hat = mu / (1 - torch.pow(_ADAM_B1, steps))
    nu_hat = nu / (1 - torch.pow(_ADAM_B2, steps))
    delta = -lr * mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)
    return delta, AdamState(mu=mu, nu=nu, count=count)


def adam_step(
    vag: ValueAndGrad,
    x: torch.Tensor,
    state: AdamState,
    lr: float,
) -> tuple[torch.Tensor, AdamState, StepAux]:
    """One Adam step on ``x``: one evaluation, ``n_evals`` of one."""
    (loss, (style, content)), grad = vag(x)
    delta, state = _adam_update_math(grad, state, lr)
    aux = StepAux(
        loss=loss,
        style_score=style,
        content_score=content,
        n_evals=torch.ones((), dtype=torch.int64, device=x.device),
    )
    return x + delta, state, aux


# ---- the multi-style batch: S independent problems, one step


def lbfgs_init_batched(
    n_styles: int,
    n: int,
    history_size: int,
    device: torch.device | str,
    history_dtype: torch.dtype = torch.float32,
) -> LbfgsState:
    """:func:`lbfgs_init` for ``n_styles`` problems, stacked on axis 0.

    The ring is ``(S, m, n)`` in ``history_dtype``; ``rho`` is ``(S,
    m)``; the scalars and counters are ``(S,)``.
    """
    one = lbfgs_init(n, history_size, device, history_dtype)
    return LbfgsState(**{
        name: getattr(one, name).expand(
            n_styles, *getattr(one, name).shape,
        ).clone()
        for name in LbfgsState.__dataclass_fields__
    })


def _style(st: LbfgsState, i: int) -> LbfgsState:
    """Style ``i``'s state: views into the batched state."""
    return LbfgsState(**{
        name: getattr(st, name)[i] for name in LbfgsState.__dataclass_fields__
    })


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(S,)`` dot products of the rows of two ``(S, n)`` tensors.

    One ``torch.dot`` per style, the single step's own reduction.
    """
    return torch.stack([torch.dot(x, y) for x, y in zip(a, b, strict=True)])


def _insert_pair_batched(
    st: LbfgsState,
    s: torch.Tensor,
    y: torch.Tensor,
    ys: torch.Tensor,
    yy: torch.Tensor,
    do_insert: torch.Tensor,
) -> None:
    """:func:`_insert_pair` per style: each ring moves on its own."""
    m = st.rho.shape[1]
    pos = st.hist_pos
    styles = torch.arange(pos.shape[0], device=pos.device)
    for ring, vec in ((st.s_hist, s), (st.y_hist, y)):
        row = torch.where(
            do_insert[:, None], vec.to(ring.dtype), ring[styles, pos],
        )
        ring.index_put_((styles, pos), row)
    st.rho = torch.where(
        (torch.arange(m, device=pos.device) == pos[:, None])
        & do_insert[:, None],
        (1.0 / ys)[:, None], st.rho,
    )
    st.hist_pos = torch.where(do_insert, (pos + 1) % m, pos)
    st.hist_len = torch.where(
        do_insert, torch.clamp(st.hist_len + 1, max=m), st.hist_len,
    )
    st.h_diag = torch.where(do_insert, ys / yy, st.h_diag)


def lbfgs_step_batched(
    vag: ValueAndGrad,
    x: torch.Tensor,
    state: LbfgsState,
    lr: float,
    *,
    max_iter: int,
    max_eval: int,
    direction_method: str = "two-loop",
    mesh=None,
) -> tuple[torch.Tensor, LbfgsState, StepAux]:
    """:func:`lbfgs_step` for S problems at once.

    ``x`` is ``(S, n)``; ``vag`` maps it to ``(S,)`` losses and scores
    and ``(S, n)`` gradients. Each style's masks are its own: a style
    that is done keeps its image, its state and its ring position
    while the others go on. Returns ``(S,)`` metrics. With ``mesh``
    (a dp x sp rank's style row) each row of ``x`` and of the state's
    vectors is this rank's rows of its style's image: every per-style
    reduction a decision or a step length reads is summed or maxed
    over the row, all S of one point in one collective, so every rank
    of a row takes each style's same branches; each style's direction
    reduces over the row as the single step's does.
    """
    try:
        direction_fn = _DIRECTION_METHODS[direction_method]
    except KeyError:
        msg = f"Unknown L-BFGS direction method: {direction_method!r}"
        raise ValueError(msg) from None
    (loss, (style, content)), grad = vag(x)
    n_styles = x.shape[0]
    dev = x.device
    (grad_max,) = _maxes(mesh, grad.abs().amax(dim=1))
    done = grad_max <= TOLERANCE_GRAD
    evals = torch.ones(n_styles, dtype=torch.int64, device=dev)
    st = state

    for n_iter in range(1, max_iter + 1):
        active = ~done
        n_total = st.n_total_iters + 1
        first = n_total == 1

        y = grad - st.prev_grad
        s = st.direction * st.step_size[:, None]
        ys, yy = _sums(mesh, _dots(y, s), _dots(y, y))
        do_insert = active & ~first & (ys > _CURVATURE_EPS)
        _insert_pair_batched(st, s, y, ys, yy, do_insert)

        with span("stv.step.direction"):
            directions = torch.stack([
                direction_fn(g, _style(st, i), mesh)
                for i, g in enumerate(grad)
            ])
            direction = torch.where(first[:, None], -grad, directions)
        l1, gtd = _sums(
            mesh, torch.stack([g.abs().sum() for g in grad]),
            _dots(grad, direction),
        )
        t = torch.where(
            first,
            torch.clamp(1.0 / l1, max=1.0) * lr,
            torch.full((n_styles,), lr, dtype=torch.float32, device=dev),
        )
        break_gtd = gtd > -TOLERANCE_CHANGE
        x_new = torch.where(break_gtd[:, None], x, x + t[:, None] * direction)

        if n_iter < max_iter:
            reeval = active & ~break_gtd
            (l_n, (s_n, c_n)), g_n = vag(x_new)
            loss_n = torch.where(reeval, l_n, loss)
            style_n = torch.where(reeval, s_n, style)
            content_n = torch.where(reeval, c_n, content)
            grad_n = torch.where(reeval[:, None], g_n, grad)
        else:
            reeval = torch.zeros(n_styles, dtype=torch.bool, device=dev)
            loss_n, style_n, content_n, grad_n = loss, style, content, grad
        evals_n = evals + reeval.to(evals.dtype)

        grad_n_max, step_max = _maxes(
            mesh, grad_n.abs().amax(dim=1),
            (t[:, None] * direction).abs().amax(dim=1),
        )
        done_n = (
            break_gtd
            | (evals_n >= max_eval)
            | (grad_n_max <= TOLERANCE_GRAD)
            | (step_max <= TOLERANCE_CHANGE)
            | ((loss_n - loss).abs() < TOLERANCE_CHANGE)
        )

        on = active[:, None]
        st.prev_grad = torch.where(on, grad, st.prev_grad)
        st.direction = torch.where(on, direction, st.direction)
        st.step_size = torch.where(active, t, st.step_size)
        st.prev_loss = torch.where(active, loss, st.prev_loss)
        st.n_total_iters = torch.where(active, n_total, st.n_total_iters)
        st.func_evals = st.func_evals + reeval.to(st.func_evals.dtype)

        x = torch.where(on, x_new, x)
        loss = torch.where(active, loss_n, loss)
        style = torch.where(active, style_n, style)
        content = torch.where(active, content_n, content)
        grad = torch.where(on, grad_n, grad)
        evals = torch.where(active, evals_n, evals)
        done = done | done_n

    st.func_evals = st.func_evals + 1
    aux = StepAux(
        loss=loss, style_score=style, content_score=content, n_evals=evals,
    )
    return x, st, aux


def adam_init_batched(
    shape: tuple[int, ...],
    device: torch.device | str,
) -> AdamState:
    """:func:`adam_init` for a stacked ``(S, ...)`` parameter.

    The count is per style, an ``(S,)`` device int32.
    """
    state = adam_init(shape, device)
    state.count = torch.zeros(shape[0], dtype=torch.int32, device=device)
    return state


def adam_step_batched(
    vag: ValueAndGrad,
    x: torch.Tensor,
    state: AdamState,
    lr: float,
) -> tuple[torch.Tensor, AdamState, StepAux]:
    """:func:`adam_step` for S stacked problems: ``(S,)`` metrics.

    Each style's bias correction uses its own count.
    """
    (loss, (style, content)), grad = vag(x)
    per_style = (-1,) + (1,) * (grad.dim() - 1)
    delta, new = _adam_update_math(
        grad,
        AdamState(
            mu=state.mu, nu=state.nu, count=state.count.view(per_style),
        ),
        lr,
    )
    new.count = new.count.reshape(-1)
    aux = StepAux(
        loss=loss,
        style_score=style,
        content_score=content,
        n_evals=torch.ones(x.shape[0], dtype=torch.int64, device=x.device),
    )
    return x + delta, new, aux
