"""The port's feature rematerialization, on the CPU.

- ``extract_features(remat=True)``: every tap and the input gradient
  bit-equal to ``remat=False``, on a tiny stack (2 pools, widths <= 16)
  and on VGG19 and VGG16 at 32x32, over several tap sets and tiers: the
  same kernels (here their plain versions) recompute the same values;
- the losses built on it (``total_loss``, ``batched_total_loss``) and a
  3-step L-BFGS run through ``build_update_step`` and the batch's
  ``build_multi_style_update``: bit-equal with and without remat;
- the resolvers ``main.resolve_single_remat`` and
  ``main._auto_remat_batched`` equal to the JAX package's with its
  thresholds put in, and ``main.prepare_model_and_input`` and
  ``main.prepare_multi_style`` handing the resolved value to the step.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu import constants as jax_constants
from style_transfer_visualizer_tpu import main as jax_main
from style_transfer_visualizer_tpu_torch import main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models import arch, features, vgg19
from style_transfer_visualizer_tpu_torch.ops.precision import (
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
    initialize_multi_inputs,
    multi_style_targets,
)

TINY_CONVS = ((0, 3, 8), (2, 8, 8), (5, 8, 16), (7, 16, 16), (10, 16, 16))
TINY_TAPS = [(0,), (2,), (0, 5, 10), (3, 7), (4, 9), (1, 6, 11), (10,)]
VGG_TAPS = {
    "vgg19": [(0, 5, 10, 19, 21, 28), (0, 5, 2), (4, 9, 18), (21,)],
    "vgg16": [(0, 5, 10, 17, 24, 19), (3, 8), (23,)],
}


def _tiny_params():
    rng = np.random.default_rng(0)
    host = {
        idx: {
            "w": (
                rng.standard_normal((3, 3, ci, co)) * np.sqrt(2.0 / (9 * ci))
            ).astype(np.float32),
            "b": (0.1 * rng.standard_normal(co)).astype(np.float32),
        }
        for idx, ci, co in TINY_CONVS
    }
    return vgg19.params_from_numpy(host, "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _tiny_params()


def _image(seed: int, shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, size=shape).astype(np.float32))


def _sweep(params, x0, taps, precision, remat):
    x = x0.clone().requires_grad_(True)
    acts = features.extract_features(params, x, taps, precision, remat=remat)
    # A loss that reads every tap, so every segment's backward runs.
    loss = sum(
        (a * torch.linspace(-1, 1, a.numel()).reshape(a.shape)).sum()
        for a in acts.values()
    )
    (grad,) = torch.autograd.grad(loss, x)
    return {k: v.detach() for k, v in acts.items()}, grad


def _assert_same(a, b) -> None:
    acts_a, grad_a = a
    acts_b, grad_b = b
    assert sorted(acts_a) == sorted(acts_b)
    for k in acts_a:
        assert torch.equal(acts_a[k], acts_b[k]), k
    assert torch.equal(grad_a, grad_b)


@pytest.mark.parametrize("taps", TINY_TAPS)
@pytest.mark.parametrize("tier", ["mixed", "highest", "default"])
def test_remat_is_bit_equal_on_a_tiny_stack(tiny, taps, tier) -> None:
    x0 = _image(1, (2, 32, 24, 3))
    precision = resolve_precision(tier)
    _assert_same(
        _sweep(tiny, x0, taps, precision, False),
        _sweep(tiny, x0, taps, precision, True),
    )


@pytest.mark.parametrize(
    ("model", "taps"),
    [(m, t) for m, sets in VGG_TAPS.items() for t in sets],
)
def test_remat_is_bit_equal_on_vgg(model, taps) -> None:
    params = vgg19.init_random_params(
        0, "cpu", arch.get_architecture(model),
    )
    x0 = _image(2, (1, 32, 32, 3))
    precision = resolve_precision("mixed")
    _assert_same(
        _sweep(params, x0, taps, precision, False),
        _sweep(params, x0, taps, precision, True),
    )


def test_remat_without_grad_runs_the_plain_sweep(tiny) -> None:
    x0 = _image(3, (1, 32, 32, 3))
    with torch.no_grad():
        a = features.extract_features(tiny, x0, (0, 5, 10), remat=True)
        b = features.extract_features(tiny, x0, (0, 5, 10))
    for k in a:
        assert torch.equal(a[k], b[k])


def _targets(params, sl, cl, shape):
    return features.compute_targets(
        params, _image(4, shape), _image(5, shape), sl, cl,
    )


@pytest.mark.parametrize("weights", [None, (1.0, 0.5, 0.25)])
def test_total_loss_with_remat_is_bit_equal(tiny, weights) -> None:
    sl, cl = (0, 5, 10), (7,)
    targets = _targets(tiny, sl, cl, (1, 32, 32, 3))
    x0 = _image(6, (1, 32, 32, 3))
    out = []
    for remat in (False, True):
        x = x0.clone().requires_grad_(True)
        total, (style, content) = features.total_loss(
            tiny, x, targets, 1e3, 1.0, sl, cl, weights, remat=remat,
        )
        (grad,) = torch.autograd.grad(total, x)
        out.append((total.detach(), style.detach(), content.detach(), grad))
    for a, b in zip(*out, strict=True):
        assert torch.equal(a, b)


def test_batched_total_loss_with_remat_is_bit_equal(tiny) -> None:
    sl, cl = (0, 5), (2,)
    content = _image(7, (1, 32, 32, 3))
    styles = [_image(8 + i, (1, 32, 32, 3)) for i in range(3)]
    targets = multi_style_targets(tiny, content, styles, sl, cl)
    x0 = _image(11, (3, 32, 32, 3))
    out = []
    for remat in (False, True):
        x = x0.clone().requires_grad_(True)
        total, _ = features.batched_total_loss(
            tiny, x, targets, 1e3, 1.0, sl, cl, remat=remat,
        )
        (grad,) = torch.autograd.grad(total.sum(), x)
        out.append((total.detach(), grad))
    for a, b in zip(*out, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_a_remat_run_is_bit_equal(tiny, optimizer) -> None:
    sl, cl = (0, 5, 10), (7,)
    shape = (1, 32, 32, 3)
    targets = _targets(tiny, sl, cl, shape)
    runs = []
    for remat in (False, True):
        bundle = build_update_step(
            tiny, targets, shape, optimizer=optimizer,
            lr=1.0 if optimizer == "lbfgs" else 0.1, style_w=1e3,
            content_w=1.0, style_layers=sl, content_layers=cl,
            lbfgs_history_dtype="bfloat16", lbfgs_direction="compact",
            remat=remat,
        )
        image, _, aux = bundle.chunked_update_fn(
            _image(12, shape), bundle.opt_state, 3,
        )
        runs.append((image, aux.loss))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_a_remat_batch_is_bit_equal(tiny) -> None:
    sl, cl = (0, 5), (2,)
    content = _image(13, (1, 32, 32, 3))
    styles = [_image(14 + i, (1, 32, 32, 3)) for i in range(2)]
    targets = multi_style_targets(tiny, content, styles, sl, cl)
    runs = []
    for remat in (False, True):
        bundle = build_multi_style_update(
            tiny, targets, tuple(content.shape), 2, style_w=1e3,
            style_layers=sl, content_layers=cl, remat=remat,
        )
        images = initialize_multi_inputs(content, "content", None, 2)
        images, _, aux = bundle.chunked_update_fn(
            images, bundle.opt_state, 3,
        )
        runs.append((images, aux.loss))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# --- the resolvers ----------------------------------------------------------


@pytest.fixture
def jax_thresholds(monkeypatch):
    for name in ("AUTO_TILE_PIXEL_THRESHOLD", "AUTO_REMAT_PIXEL_THRESHOLD",
                 "BATCH_AUTO_REMAT_PIXEL_THRESHOLD"):
        monkeypatch.setattr(main, name, getattr(jax_constants, name))


SIDES = (512, 1080, 1920, 2047, 2048, 2160, 2560, 3840, 4096, 7680)


@pytest.mark.parametrize("height", SIDES)
def test_resolve_single_remat_matches_jax(jax_thresholds, height) -> None:
    for width, tile_rows, requested in itertools.product(
        SIDES, (0, 16, 720), (False, True),
    ):
        assert main.resolve_single_remat(
            height, width, tile_rows, requested,
        ) == jax_main.resolve_single_remat(
            height, width, tile_rows, requested,
        )


@pytest.mark.parametrize("styles", [1, 2, 4, 8, 16, 24, 32, 64])
def test_auto_remat_batched_matches_jax(jax_thresholds, styles) -> None:
    for side in SIDES:
        assert main._auto_remat_batched(  # noqa: SLF001
            side * side, styles,
        ) == jax_main._auto_remat_batched(side * side, styles)  # noqa: SLF001


def _capture_step(monkeypatch, name: str) -> list:
    seen: list = []
    real = getattr(main, name)

    def spy(*args, **kwargs):
        seen.append((kwargs.get("remat"), kwargs.get("tile_rows")))
        return real(*args, **kwargs)

    monkeypatch.setattr(main, name, spy)
    return seen


def _config(**opt) -> StyleTransferConfig:
    return StyleTransferConfig(
        optimization=OptimizationConfig(
            steps=1, style_layers=[0, 5], content_layers=[2],
            coarse_steps=0, allow_random_weights=True,
            init_method="content", **opt,
        ),
        hardware=HardwareConfig(device="cpu"),
    )


@pytest.mark.parametrize(
    ("opt", "threshold", "want"),
    [({}, None, (False, 0)), ({"remat": True}, None, (True, 0)),
     ({}, 64 * 64, (True, 0)), ({"tile_rows": 16}, 64 * 64, (False, 16)),
     ({"tile_rows": 16, "remat": True}, None, (False, 16))],
)
def test_prepare_model_and_input_passes_the_resolved_policy(
    monkeypatch, opt, threshold, want,
) -> None:
    if threshold is not None:
        monkeypatch.setattr(main, "AUTO_REMAT_PIXEL_THRESHOLD", threshold)
    seen = _capture_step(monkeypatch, "build_update_step")
    rng = np.random.default_rng(15)
    arrays = [
        rng.uniform(size=(1, 64, 64, 3)).astype(np.float32) for _ in range(2)
    ]
    main.prepare_model_and_input(*arrays, _config(**opt))
    assert seen == [want]


@pytest.mark.parametrize(
    ("opt", "threshold", "want"),
    [({}, None, False), ({"remat": True}, None, True),
     ({}, 2 * 64 * 64, True), ({}, 2 * 64 * 64 + 1, False)],
)
def test_prepare_multi_style_passes_the_batch_remat(
    monkeypatch, opt, threshold, want,
) -> None:
    if threshold is not None:
        monkeypatch.setattr(
            main, "BATCH_AUTO_REMAT_PIXEL_THRESHOLD", threshold,
        )
    seen = _capture_step(monkeypatch, "build_multi_style_update")
    rng = np.random.default_rng(16)
    content = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    styles = [
        rng.uniform(size=(1, 48, 48, 3)).astype(np.float32) for _ in range(2)
    ]
    main.prepare_multi_style(content, styles, _config(**opt))
    assert seen == [(want, None)]
