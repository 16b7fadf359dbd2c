"""The port's main path as a whole vs the JAX package, on the CPU.

Full-width VGG19 with seeded weights at 32x32 (as ``tests/test_blend.py``
sizes its runs), default taps and loss weights. Both sides get the same
numpy images. Tolerances, each set from float32 with sums in different
orders: loss value rel 1e-5; gradient max-abs error 1e-4 relative to
its largest magnitude; the L-BFGS loss curve 1e-3 relative per step
(the curve gate of the JAX package's ``ops/precision.py``); the
optimizer alone on a quadratic 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.engine import optimizers as jax_opt
from style_transfer_visualizer_tpu.engine.step import (
    build_update_step as jax_build_update_step,
)
from style_transfer_visualizer_tpu.image_io import normalize_image
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.models.features import (
    compute_targets as jax_compute_targets,
    total_loss as jax_total_loss,
)
from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.engine import optimizers
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.main import (
    run_style_transfer,
    style_transfer,
)
from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
    total_loss,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths

STYLE = (0, 5, 10, 19, 28)
CONTENT = (21,)
STYLE_W, CONTENT_W = 1e5, 1.0
SEED = 0


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    content, style, init = (
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
        for _ in range(3)
    )
    return content, style, init


@pytest.fixture(scope="module")
def jax_side(images):
    content, style, _ = images
    params = jax_vgg19.init_random_params(jax.random.key(SEED))
    targets = jax_compute_targets(
        params, normalize_image(jnp.asarray(style)),
        normalize_image(jnp.asarray(content)), STYLE, CONTENT,
    )
    return params, targets


@pytest.fixture(scope="module")
def torch_side(images):
    content, style, _ = images
    params = vgg19.init_random_params(SEED, "cpu")
    targets = compute_targets(
        params,
        image_io.host_array_to_device(style, "cpu", normalize=True),
        image_io.host_array_to_device(content, "cpu", normalize=True),
        STYLE, CONTENT,
    )
    return params, targets


def test_total_loss_and_gradient_match_jax(images, jax_side, torch_side):
    x = images[2]
    params_j, targets_j = jax_side

    def loss_j(xx):
        total, _ = jax_total_loss(
            params_j, xx, targets_j, STYLE_W, CONTENT_W, STYLE, CONTENT,
        )
        return total

    ref_loss, ref_grad = jax.value_and_grad(loss_j)(jnp.asarray(x))

    params_t, targets_t = torch_side
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    total, _ = total_loss(
        params_t, xt, targets_t, STYLE_W, CONTENT_W, STYLE, CONTENT,
    )
    total.backward()
    np.testing.assert_allclose(
        float(total.detach()), float(ref_loss), rtol=1e-5,
    )
    ref_grad = np.asarray(ref_grad)
    err = np.abs(xt.grad.numpy() - ref_grad).max()
    assert err <= 1e-4 * np.abs(ref_grad).max()


def test_lbfgs_trajectory_matches_jax(images, jax_side, torch_side):
    x0 = images[2]
    params_j, targets_j = jax_side
    bundle_j = jax_build_update_step(
        params_j, targets_j, x0.shape, optimizer="lbfgs", lr=1.0,
        style_w=STYLE_W, content_w=CONTENT_W, style_layers=STYLE,
        content_layers=CONTENT, precision="highest",
        lbfgs_history_size=100, lbfgs_history_dtype="bfloat16",
        lbfgs_direction="compact",
    )
    params_t, targets_t = torch_side
    bundle_t = build_update_step(
        params_t, targets_t, x0.shape, lr=1.0, style_w=STYLE_W,
        content_w=CONTENT_W, style_layers=STYLE, content_layers=CONTENT,
        lbfgs_history_size=100, lbfgs_history_dtype="bfloat16",
        lbfgs_direction="compact",
    )
    img_j, st_j = jnp.asarray(x0), bundle_j.opt_state
    img_t, st_t = torch.from_numpy(x0.copy()), bundle_t.opt_state
    curve_j, curve_t = [], []
    for _ in range(5):
        img_j, st_j, aux_j = bundle_j.update_fn(img_j, st_j)
        img_t, st_t, aux_t = bundle_t.update_fn(img_t, st_t)
        curve_j.append(float(aux_j.loss))
        curve_t.append(float(aux_t.loss))
    np.testing.assert_allclose(curve_t, curve_j, rtol=1e-3)
    assert int(st_t.hist_len) == int(st_j.hist_len) >= 1


def _quadratic(n: int, seed: int):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    # Condition number 100: L-BFGS is still far from round-off-level
    # convergence after the steps below, where implementations part.
    a = (q * np.geomspace(0.05, 5.0, n)) @ q.T
    b = rng.normal(size=n)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("direction", ["two-loop", "compact"])
def test_optimizer_on_quadratic_matches_jax(direction, max_iter) -> None:
    n, m, steps = 24, 5, 12 // max_iter
    a, b = _quadratic(n, 3)
    x0 = np.random.default_rng(4).normal(size=n).astype(np.float32)

    def vag_j(x):
        loss = 0.5 * x @ (jnp.asarray(a) @ x) - jnp.asarray(b) @ x
        grad = jnp.asarray(a) @ x - jnp.asarray(b)
        return (loss, (loss, jnp.zeros(()))), grad

    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def vag_t(x):
        loss = 0.5 * x @ (at @ x) - bt @ x
        return (loss, (loss, torch.zeros(()))), at @ x - bt

    step_j = jax.jit(
        lambda x, st: jax_opt.lbfgs_step(
            vag_j, x, st, 1.0, max_iter=max_iter, max_eval=max_iter + 1,
            history_size=m, direction_method=direction,
        ),
    )
    x_j, st_j = jnp.asarray(x0), jax_opt.lbfgs_init(n, m)
    x_t, st_t = torch.from_numpy(x0.copy()), optimizers.lbfgs_init(n, m, "cpu")
    for _ in range(steps):
        x_j, st_j, aux_j = step_j(x_j, st_j)
        x_t, st_t, aux_t = optimizers.lbfgs_step(
            vag_t, x_t, st_t, 1.0, max_iter=max_iter,
            max_eval=max_iter + 1, direction_method=direction,
        )
        ref = np.asarray(x_j)
        np.testing.assert_allclose(
            x_t.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
        )
        assert int(aux_t.n_evals) == int(aux_j.n_evals)
    assert int(st_t.func_evals) == int(st_j.func_evals)
    assert int(st_t.hist_len) == int(st_j.hist_len)


def _cpu_config(tmp_path, steps: int, init: str = "random"):
    return StyleTransferConfig(
        output=OutputConfig(output=str(tmp_path / "out"), log_every=2),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True, init_method=init,
        ),
        hardware=HardwareConfig(device="cpu"),
    )


def test_run_style_transfer_matches_jax_losses(
    images, jax_side, tmp_path, monkeypatch,
) -> None:
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    content, style, _ = images
    image, history = run_style_transfer(
        content, style, _cpu_config(tmp_path, 3, init="content"),
    )
    params_j, targets_j = jax_side
    bundle_j = jax_build_update_step(
        params_j, targets_j, content.shape, optimizer="lbfgs", lr=1.0,
        style_w=STYLE_W, content_w=CONTENT_W, style_layers=STYLE,
        content_layers=CONTENT, precision="highest",
        lbfgs_history_size=100, lbfgs_history_dtype="bfloat16",
        lbfgs_direction="compact",
    )
    img_j = normalize_image(jnp.asarray(content))
    st_j = bundle_j.opt_state
    ref = []
    for _ in range(3):
        img_j, st_j, aux_j = bundle_j.update_fn(img_j, st_j)
        ref.append(float(aux_j.loss))
    np.testing.assert_allclose(history["total_loss"], ref, rtol=1e-3)
    assert image.shape == (1, 32, 32, 3)
    assert float(image.min()) >= 0.0
    assert float(image.max()) <= 1.0


def test_style_transfer_end_to_end_writes_png(
    content_image, style_image, tmp_path, monkeypatch,
) -> None:
    from PIL import Image  # noqa: PLC0415

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    config = _cpu_config(tmp_path, 2)
    image = style_transfer(
        InputPaths(str(content_image), str(style_image)), config,
    )
    out = tmp_path / "out" / "stylized_content_x_style.png"
    assert out.is_file()
    with Image.open(out) as png:
        assert png.size == (64, 64)
    assert torch.isfinite(image).all()
