"""The port's row-sharded functions vs the JAX package, on the CPU.

The JAX side runs in this process on its virtual CPU devices
(``create_mesh(n_style=1, n_space=N)``, ``make_spatial_loss``,
``compute_sharded_targets`` at ``HIGHEST``); the port's side runs N
gloo ranks (``parallel.mesh.launch``), one spawn per N = 1, 2, 4, whose
ranks run every case (``tests/torch_spatial_workers.py``) on the same
seeded numpy inputs and weights (a tiny stack: 2 pools, widths <= 16,
heights 32-64). Tolerances, each from float32 sums in other orders:

- the sharded loss within 1e-5 relative of the JAX package's, the
  same on every rank;
- its gradient within 1e-4 of its largest magnitude of the JAX sharded
  gradient and of the port's whole-image gradient (the whole-image
  comparison catches a gradient N times too large);
- each rank's halo rows its neighbours' edge rows bit for bit (a
  negative zero included), zeros at the image's edges;
- ``compute_sharded_targets``: Grams within 1e-6 relative, features
  within 1e-5;
- the exchange's backward by ``torch.autograd.gradcheck`` in float64;
- the L-BFGS step over the ranks within 1e-5 of the whole step;
- the validation messages equal to the JAX package's.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.parallel import mesh as jax_mesh
from style_transfer_visualizer_tpu.parallel import spatial as jax_spatial
from style_transfer_visualizer_tpu_torch.engine import step
from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    lbfgs_init,
    lbfgs_step,
)
from style_transfer_visualizer_tpu_torch.models import features, vgg19
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.parallel import mesh, spatial
from tests import torch_spatial_workers

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAM_RTOL = 1e-6
FEAT_RTOL = 1e-5
LBFGS_RTOL = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST
N_SPACES = (1, 2, 4)
#: Seconds a battery's ranks may take in all (a loaded host runs them
#: several times slower than an idle one); one collective's bound.
DEADLINE = 600.0
TIMEOUT = 300.0
#: The tiny stack: convs (index, C_in, C_out); a pool after 3 and 8,
#: as in VGG19's first layers.
TINY_CONVS = ((0, 3, 8), (2, 8, 8), (5, 8, 16), (7, 16, 16), (10, 16, 16))
#: name -> (style layers, content layers, (H, W), loss settings)
LOSS_CASES = {
    "style_content": ((0, 5, 10), (7,), (64, 16), {
        "style_w": 10.0, "content_w": 1.0,
    }),
    "style_weights": ((0, 5), (2,), (32, 24), {
        "style_w": 10.0, "content_w": 1.0, "style_weights": (2.0, 0.25),
    }),
    "tv": ((0,), (), (32, 24), {
        "style_w": 0.0, "content_w": 0.0, "tv_w": 1.0,
    }),
    "lap": ((0,), (), (48, 24), {
        "style_w": 0.0, "content_w": 0.0, "lap_w": 1.0, "lap_pool": 4,
    }),
    "every_term": ((0, 5, 10), (7,), (64, 16), {
        "style_w": 10.0, "content_w": 1.0, "tv_w": 0.5, "lap_w": 2.0,
        "lap_pool": 2, "style_weights": (1.0, 0.5, 2.0),
    }),
}
#: name -> (style layers, content layers, (H, W))
TARGET_CASES = {
    "deep": ((0, 5, 10), (7,), (64, 16)),
    "content_only": ((), (2, 5), (32, 24)),
}
HALO_SHAPE = (1, 3, 5, 2)   # rows per rank, then W and C


def _tiny_host(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        idx: {
            "w": (
                rng.standard_normal((3, 3, ci, co)) * np.sqrt(2.0 / (9 * ci))
            ).astype(np.float32),
            "b": (0.1 * rng.standard_normal(co)).astype(np.float32),
        }
        for idx, ci, co in TINY_CONVS
    }


def _image(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5, 1.5, size=(1, h, w, 3)).astype(np.float32)


@functools.cache
def _jax_params():
    return {
        i: {k: jnp.asarray(v) for k, v in layer.items()}
        for i, layer in _tiny_host().items()
    }


def _jax_sharded_targets(n: int, params, style, content, sl, cl):
    """The JAX package's ``compute_sharded_targets``, jitted."""
    jmesh = jax_mesh.create_mesh(n_style=1, n_space=n)
    return jax.jit(lambda p, s, c: jax_spatial.compute_sharded_targets(
        jmesh, p, s, c, sl, cl, precision=HIGHEST,
    ))(params, style, content)


def _jax_targets(n: int, sl, cl, hw, settings):
    """The JAX package's targets for a loss case: whole Grams, sharded
    content features (and the padded Laplacian target)."""
    h, w = hw
    content = jnp.asarray(_image(1, h, w))
    style = jnp.asarray(_image(2, h, w))
    params = _jax_params()
    grams = jax_features.compute_targets(
        params, style, content, sl, (), precision=HIGHEST,
    ).style_grams
    feats = {}
    if cl:
        feats = dict(_jax_sharded_targets(n, params, content, content, (), cl)
                     .content_feats)
    if settings.get("lap_w"):
        feats[jax_spatial.LAP_RESPONSE_KEY] = jax_spatial.padded_lap_target(
            content, settings["lap_pool"],
        )
    return content, jax_features.Targets(
        style_grams=grams, content_feats=feats,
    )


@functools.cache
def _jax_loss(n: int, name: str):
    """``(total, style, content, grad, targets as numpy)`` of the JAX
    sharded loss at the case's ``x``."""
    sl, cl, hw, settings = LOSS_CASES[name]
    content, targets = _jax_targets(n, sl, cl, hw, settings)
    x = content * 0.5 + 0.1
    loss_fn = jax_spatial.make_spatial_loss(
        jax_mesh.create_mesh(n_style=1, n_space=n), tuple(x.shape),
        style_layers=sl, content_layers=cl, precision=HIGHEST, **settings,
    )
    (total, (style, content_score)), grad = jax.jit(jax.value_and_grad(
        lambda v, t: loss_fn(_jax_params(), v, t), has_aux=True,
    ))(x, targets)
    as_np = {
        "x": np.asarray(x),
        "grams": {k: np.asarray(v) for k, v in targets.style_grams.items()},
        "feats": {k: np.asarray(v) for k, v in targets.content_feats.items()},
    }
    return (
        float(total), float(style), float(content_score), np.asarray(grad),
        as_np,
    )


def _cases(n: int) -> dict:
    loss = {}
    for name, (sl, cl, _, settings) in LOSS_CASES.items():
        *_, as_np = _jax_loss(n, name)
        loss[name] = {
            **as_np,
            "settings": {
                "style_layers": sl, "content_layers": cl, **settings,
            },
        }
    targets = {
        name: {
            "style": _image(2, *hw), "content": _image(1, *hw),
            "style_layers": sl, "content_layers": cl,
        }
        for name, (sl, cl, hw) in TARGET_CASES.items()
    }
    return {
        "weights": _tiny_host(), "loss": loss, "targets": targets,
        "halo_x": _halo_input(n), "lbfgs": _lbfgs_problem(n),
    }


def _halo_input(n: int) -> np.ndarray:
    """Seeded rows with a negative zero in every rank's edge rows."""
    _, rows, w, c = HALO_SHAPE
    x = np.random.default_rng(5).standard_normal(
        (1, rows * n, w, c),
    ).astype(np.float32)
    x[:, ::rows, 0, 0] = -0.0
    x[:, rows - 1::rows, 1, 1] = -0.0
    return x


def _lbfgs_problem(n: int) -> dict:
    rng = np.random.default_rng(7)
    size = 24
    return {
        "a": rng.uniform(0.5, 2.0, size).astype(np.float32),
        "b": rng.standard_normal(size).astype(np.float32),
        "x0": rng.standard_normal(size).astype(np.float32),
    }


@pytest.fixture(scope="module", params=N_SPACES, ids=lambda n: f"n{n}")
def ranks(request):
    """``(N, rank 0's battery results)``: one spawn of N gloo ranks."""
    n = request.param
    out = mesh.launch(
        torch_spatial_workers.function_battery, (_cases(n),), n, "cpu",
        timeout=TIMEOUT, deadline=DEADLINE,
    )
    assert out["size"] == n
    return n, out


def _grad_err(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


# --- the loss and its gradient ---------------------------------------


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_sharded_loss_matches_jax(ranks, name) -> None:
    n, out = ranks
    got = out[f"loss/{name}"]
    total, style, content, _, _ = _jax_loss(n, name)
    assert got["loss"].shape == (n,)
    # Replicated: every rank holds the same scalar.
    assert np.all(got["loss"] == got["loss"][0])
    assert abs(float(got["loss"][0]) - total) <= LOSS_RTOL * abs(total)
    for ours, ref in ((got["style"], style), (got["content"], content)):
        assert abs(float(ours) - ref) <= LOSS_RTOL * max(abs(ref), 1e-30)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_sharded_gradient_matches_jax(ranks, name) -> None:
    n, out = ranks
    *_, grad, _ = _jax_loss(n, name)
    assert _grad_err(out[f"loss/{name}"]["grad"], grad) <= GRAD_RTOL


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_sharded_loss_and_gradient_match_the_whole_image(
    ranks, name,
) -> None:
    """The port's own whole-image objective on the same targets: no
    factor of N on the gradient from the sums' backward."""
    n, out = ranks
    sl, cl, _, settings = LOSS_CASES[name]
    *_, as_np = _jax_loss(n, name)
    params = vgg19.params_from_numpy(_tiny_host(), "cpu")
    targets = features.Targets(
        style_grams={
            k: torch.from_numpy(np.array(v)) for k, v in as_np["grams"].items()
        },
        content_feats={
            k: torch.from_numpy(np.array(v))
            for k, v in as_np["feats"].items()
            if k != spatial.LAP_RESPONSE_KEY
        },
    )
    content = torch.from_numpy(_image(1, *LOSS_CASES[name][2]))
    loss_fn = step.make_objective(
        style_layers=sl, content_layers=cl, **settings,
    )
    if settings.get("lap_w"):
        targets = (targets, lap_response(content, settings["lap_pool"]))
    x = torch.from_numpy(np.array(as_np["x"])).requires_grad_(True)
    total, _ = loss_fn(params, x, targets)
    (grad,) = torch.autograd.grad(total, x)
    got = out[f"loss/{name}"]
    total = float(total.detach())
    assert abs(float(got["loss"][0]) - total) <= LOSS_RTOL * abs(total)
    assert _grad_err(got["grad"], grad.numpy()) <= GRAD_RTOL


# --- targets, halos, the exchange's backward, L-BFGS ------------------


@pytest.mark.parametrize("name", list(TARGET_CASES))
def test_sharded_targets_match_jax(ranks, name) -> None:
    n, out = ranks
    sl, cl, hw = TARGET_CASES[name]
    ref = _jax_sharded_targets(
        n, _jax_params(), jnp.asarray(_image(2, *hw)),
        jnp.asarray(_image(1, *hw)), sl, cl,
    )
    got = out[f"targets/{name}"]
    assert sorted(k for k in got if k.startswith("gram")) == sorted(
        f"gram{k}" for k in sl
    )
    for k, v in ref.style_grams.items():
        v = np.asarray(v)
        assert np.abs(got[f"gram{k}"] - v).max() <= GRAM_RTOL * np.abs(v).max()
    for k, v in ref.content_feats.items():
        v = np.asarray(v)
        assert np.abs(got[f"feat{k}"] - v).max() <= FEAT_RTOL * np.abs(v).max()


def test_halo_rows_are_the_neighbours_edges_bit_for_bit(ranks) -> None:
    n, out = ranks
    _, rows, w, c = HALO_SHAPE
    x = _halo_input(n)
    got = out["halos"]
    assert got.shape == (1, n * (rows + 2), w, c)
    for r in range(n):
        block = got[:, r * (rows + 2):(r + 1) * (rows + 2)]
        top = x[:, r * rows - 1] if r > 0 else np.zeros((1, w, c), np.float32)
        bottom = (
            x[:, (r + 1) * rows] if r < n - 1
            else np.zeros((1, w, c), np.float32)
        )
        want = np.concatenate([
            top[:, None], x[:, r * rows:(r + 1) * rows], bottom[:, None],
        ], axis=1)
        assert np.array_equal(block.view(np.uint32), want.view(np.uint32))


def test_sharded_loss_and_gradient_span_only_their_gathers(ranks) -> None:
    """Under a profiler the sharded loss and gradient make no span per
    halo exchange or sum over the ranks (dozens a step); the gather of
    the rows to rank 0, where there are ranks to reach, is a span."""
    n, out = ranks
    assert set(out["spans"]) == ({"stv.parallel.gather"} if n > 1 else set())


def test_exchange_backward_passes_gradcheck(ranks) -> None:
    _, out = ranks
    assert out["gradcheck"] is True


@pytest.mark.parametrize("method", ["compact", "two-loop"])
def test_lbfgs_over_the_ranks_matches_the_whole_step(ranks, method) -> None:
    _, out = ranks
    problem = {k: torch.from_numpy(v) for k, v in _lbfgs_problem(1).items()}
    a, b = problem["a"], problem["b"]

    def vag(v):
        loss = torch.sum(a * v * v + b * v)
        return (loss, (loss, loss)), 2 * a * v + b

    state = lbfgs_init(a.shape[0], 4, "cpu")
    v = problem["x0"].clone()
    for _ in range(3):
        v, state, _ = lbfgs_step(
            vag, v, state, 1.0, max_iter=2, max_eval=3,
            direction_method=method,
        )
    np.testing.assert_allclose(
        out["lbfgs"][method], v.numpy(), rtol=LBFGS_RTOL, atol=LBFGS_RTOL,
    )


# --- validation, the mesh -------------------------------------------


def _message(fn, *args) -> str | None:
    try:
        fn(*args)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize(
    ("h", "n", "taps"),
    [
        (64, 2, (0, 5, 10)), (48, 4, (0, 5, 10)), (40, 4, (0, 5)),
        (64, 4, (21, 28)), (96, 2, (28,)), (30, 2, (0,)), (64, 1, ()),
    ],
)
def test_shard_divisibility_messages_match_jax(h, n, taps) -> None:
    assert _message(spatial.validate_shard_divisibility, h, n, taps) == (
        _message(jax_spatial.validate_shard_divisibility, h, n, taps)
    )


@pytest.mark.parametrize(
    ("h", "n", "pool"),
    [(64, 2, 4), (48, 4, 4), (40, 4, 4), (8, 4, 2), (12, 2, 4), (64, 8, 4)],
)
def test_lap_divisibility_messages_match_jax(h, n, pool) -> None:
    assert _message(spatial.validate_lap_shard_divisibility, h, n, pool) == (
        _message(jax_spatial.validate_lap_shard_divisibility, h, n, pool)
    )


def test_padded_lap_target_matches_jax() -> None:
    img = _image(3, 32, 24)
    ours = spatial.padded_lap_target(torch.from_numpy(img), 4).numpy()
    ref = np.asarray(jax_spatial.padded_lap_target(jnp.asarray(img), 4))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_a_style_axis_waits_for_its_queue_item(tmp_path) -> None:
    """A style axis is built, not refused (its 2 x 2 runs are
    ``tests/test_torch_batch_mesh.py``'s): in one process, the mesh of
    a one-rank group, and the rank count a 2 x 2 mesh needs."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0,
    )
    try:
        one = mesh.create_mesh(1, 1, device="cpu")
        assert (one.style_index, one.style_size, one.index, one.size) == (
            0, 1, 0, 1,
        )
        assert one.writes and one.is_root
        with pytest.raises(ValueError, match="Mesh 2x2 needs 4 devices"):
            mesh.create_mesh(n_style=2, n_space=2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_single_device_mesh_runs_the_loss_without_collectives() -> None:
    one = mesh.single_device_mesh("cpu")
    assert (one.index, one.size, one.group) == (0, 1, None)
    assert one.rows(32) == (0, 32)
    x = torch.from_numpy(_image(4, 8, 6))
    halo = spatial.exchange_halos(x, one)
    assert torch.equal(halo[:, 1:-1], x)
    assert not halo[:, [0, -1]].any()


def test_too_few_cards_raise_the_jax_message(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(
        ValueError, match=r"--spatial-shards 2 needs 2 cuda devices; "
        r"1 attached\.",
    ):
        mesh.launch(print, (), 2, "cuda")


def test_a_step_that_holds_a_group_dispatches_eagerly() -> None:
    held = mesh.Mesh(group=object(), index=0, size=2, device=torch.device(
        "cpu",
    ))
    with pytest.raises(ValueError, match="dispatches eagerly"):
        step.GraphedChunk(lambda image, state: (image, state, None), held)
    chunk = step.chunked(lambda image, state: (image, state, None), held)
    assert isinstance(chunk, step.EagerChunk)
    assert type(step.chunked(print)) is step.GraphedChunk
