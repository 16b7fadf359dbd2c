"""The port's multi-style batch over a style x space mesh, on the CPU.

The port's side runs gloo ranks (``parallel.mesh.launch`` with a style
axis), one spawn per layout whose ranks run every case
(``tests/torch_batch_workers.py``); the JAX side runs in this process
on the 8 virtual CPU devices of ``tests/conftest.py``, whose 2 x 2 mesh
is the JAX package's ``create_mesh(n_style=2, n_space=2)``. The same
seeded numpy inputs and seeded VGG19 weights go to both: taps [0, 5]
/ [2] at 32x32 for the step (``tests/parallel/test_parallel.py``'s
setup), 64x64 for the runs. Gates:

- step 0 on the 2 x 2 mesh, per style, every term of the objective
  on (style, content, TV, Laplacian): the loss and scores within 1e-5
  relative of the JAX ``build_dp_sp_update``'s, the gradient within
  1e-4 of its largest magnitude of the JAX sharded objective's (the
  single run's sharded tolerances, ``tests/test_torch_spatial.py``);
- 3 Adam steps on the 2 x 2 mesh with the same terms (the JAX tests'
  plain, TV and Laplacian cases in one, which halves the JAX side's
  compiles): each style's images and losses against the JAX
  ``build_dp_sp_update``'s at its own tolerances for this path
  (``rtol=2e-3, atol=1e-5``; losses ``rtol=1e-3``). They start off the
  content image: at the content the content and Laplacian gradients
  are rounding noise of about 1e-9, under Adam's eps of 1e-8, where
  Adam's first step turns a 1e-10 difference in a pixel's gradient
  into 1e-3 of the pixel (the port's single-process batch misses the
  gate there too);
- 3 L-BFGS steps (two-loop and compact fp32 rings, compact bf16): each
  style against the JAX single-device ``build_update_step`` at the
  same tolerances, and against the port's own single-process batch
  within ``LBFGS_RTOL`` (the JAX ``build_dp_sp_update`` L-BFGS is the
  JAX path that fails on every run, ROADMAP.md section 3 item 2);
- the 2 x 2 step is eager, its 3 steps in one dispatch bit-equal to 3
  single steps; the rank layout is the JAX grid;
- a pure style axis (2 x 1) through ``prepare_multi_style``: each
  style's start (a random draw, warm started), images and state after
  3 L-BFGS steps with every term within 1e-6 of the single-process
  S = 2 batch's, its step graphed. CPU sums
  may split by batch size (``F.conv2d``) and by thread count, and 3
  L-BFGS steps turn that into 1e-3; the card's kernels split neither.
  So the plain conv runs image by image on both sides, and the
  reference at the ranks' thread count;
- the entry point over 2 x 2 against the JAX ``multi_style_transfer``
  (the call of ``tests/test_cli.py``'s dp x sp test): per-style PNGs
  at the goldens' gates (SSIM >= 0.98, MAD <= 2), CSV rows within 1e-3;
- a 2 x 2 run checkpointed at step 2 and resumed bit-equal to the
  uninterrupted run; its checkpoint resumes the single-process batch;
- ``--styles`` with ``--spatial-shards`` on the CLI, the mesh repair
  (no CPU fallback) and the card count a mesh needs.
"""
from __future__ import annotations

import csv
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu import main as jax_main
from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.engine import step as jax_step
from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.parallel import mesh as jax_mesh
from style_transfer_visualizer_tpu.parallel import spatial as jax_spatial
from style_transfer_visualizer_tpu_torch import cli, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.features import Targets
from style_transfer_visualizer_tpu_torch.ops import conv3x3
from style_transfer_visualizer_tpu_torch.parallel import mesh, multistyle
from tests import goldens_lib, torch_batch_workers

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
IMAGE_RTOL, IMAGE_ATOL = 2e-3, 1e-5
CURVE_RTOL = 1e-3
LBFGS_RTOL = 1e-5
SAME_ATOL = 1e-6
HIGHEST = jax.lax.Precision.HIGHEST
STYLE, CONTENT = (0, 5), (2,)
SIZE = 32
STEPS = 3
#: Seconds a battery's ranks may take in all (a loaded host runs them
#: several times slower than an idle one); one collective's bound.
DEADLINE = 600.0
TIMEOUT = 300.0
#: The Adam case, every term of the objective on: the JAX dp x sp test's
#: weights with its TV and Laplacian tests' terms together.
ADAM = "adam"
_ADAM = {
    "optimizer": "adam", "lr": 0.1, "style_w": 10.0, "content_w": 1.0,
    "tv_w": 5.0, "lap_w": 3.0, "lap_pool": 4,
}
LBFGS_CASES = {
    f"lbfgs-{direction}-{dtype}": {
        "optimizer": "lbfgs", "lr": 0.1, "style_w": 10.0, "content_w": 1.0,
        "lbfgs_history_size": 4, "lbfgs_max_iter": 1, "lbfgs_max_eval": 1,
        "lbfgs_direction": direction, "lbfgs_history_dtype": dtype,
    }
    for direction, dtype in (
        ("two-loop", "float32"), ("compact", "float32"),
        ("compact", "bfloat16"),
    )
}


# --- the JAX side ------------------------------------------------------


@functools.cache
def _jax_params():
    return jax_vgg19.init_random_params(jax.random.key(0))


@functools.cache
def _inputs() -> tuple[np.ndarray, list[np.ndarray]]:
    """``_dp_sp_setup``'s content and two styles, as numpy."""
    rng = np.random.default_rng(5)
    content = rng.uniform(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    styles = [
        rng.uniform(size=(1, SIZE, SIZE, 3)).astype(np.float32)
        for _ in range(2)
    ]
    return content, styles


def _np_targets(targets) -> dict:
    return {
        "grams": {k: np.asarray(v) for k, v in targets.style_grams.items()},
        "feats": {k: np.asarray(v) for k, v in targets.content_feats.items()},
    }


@functools.cache
def _jax_dp_sp(name: str):
    """The JAX ``build_dp_sp_update`` on its 2 x 2 mesh: ``(the stacked
    targets as numpy, per-step images, per-step aux)``."""
    kwargs = dict(_ADAM)
    content = jnp.asarray(_inputs()[0])
    styles = [jnp.asarray(s) for s in _inputs()[1]]
    jmesh = jax_mesh.create_mesh(n_style=2, n_space=2)
    per_style = [
        jax_spatial.compute_sharded_targets(
            jmesh, _jax_params(), s, content, STYLE, CONTENT,
            precision=HIGHEST,
        )
        for s in styles
    ]
    feats = {
        k: jnp.stack([t.content_feats[k] for t in per_style])
        for k in CONTENT
    }
    if kwargs.get("lap_w"):
        pad = jax_spatial.padded_lap_target(content, kwargs["lap_pool"])
        feats[jax_spatial.LAP_RESPONSE_KEY] = jnp.stack([pad, pad])
    stacked = jax_features.Targets(
        style_grams={
            k: jnp.stack([t.style_grams[k] for t in per_style])
            for k in STYLE
        },
        content_feats=feats,
    )
    as_np = _np_targets(stacked)
    update_fn, state, _ = jax_spatial.build_dp_sp_update(
        jmesh, _jax_params(), stacked, tuple(content.shape), 2,
        style_layers=STYLE, content_layers=CONTENT, precision=HIGHEST,
        **kwargs,
    )
    images = jnp.asarray(_start(name))
    traj = []
    for _ in range(STEPS):
        images, state, aux = update_fn(images, state)
        traj.append((
            np.asarray(images),
            {f: np.asarray(getattr(aux, f))
             for f in ("loss", "style_score", "content_score")},
        ))
    return as_np, traj


def _start(name: str) -> np.ndarray:
    """A case's ``(2, 1, H, W, 3)`` starting images: Adam's (and step
    0's) off the content image, L-BFGS's on it (the JAX tests')."""
    content = _inputs()[0]
    if name != ADAM:
        return np.stack([content, content])
    return np.stack([content * 0.5 + 0.1, content * 0.3 + 0.2])


@functools.cache
def _whole_targets() -> dict:
    """Each style's whole-image JAX targets, stacked, as numpy."""
    content = jnp.asarray(_inputs()[0])
    per_style = [
        jax_features.compute_targets(
            _jax_params(), jnp.asarray(s), content, STYLE, CONTENT,
            precision=HIGHEST,
        )
        for s in _inputs()[1]
    ]
    return {
        "grams": {
            k: np.stack([np.asarray(t.style_grams[k]) for t in per_style])
            for k in STYLE
        },
        "feats": {
            k: np.stack([np.asarray(t.content_feats[k]) for t in per_style])
            for k in CONTENT
        },
    }


@functools.cache
def _jax_single(name: str, style: int):
    """The JAX single-device step for one style: per-step images and
    losses."""
    kwargs = dict(LBFGS_CASES[name])
    whole = _whole_targets()
    targets = jax_features.Targets(
        style_grams={
            k: jnp.asarray(v[style]) for k, v in whole["grams"].items()
        },
        content_feats={
            k: jnp.asarray(v[style]) for k, v in whole["feats"].items()
        },
    )
    content = jnp.asarray(_inputs()[0])
    single = jax_step.build_update_step(
        _jax_params(), targets, tuple(content.shape), style_layers=STYLE,
        content_layers=CONTENT, precision="highest", **kwargs,
    )
    x, state = content, single.opt_state
    out = []
    for _ in range(STEPS):
        x, state, aux = single.update_fn(x, state)
        out.append((np.asarray(x), float(aux.loss)))
    return out


@functools.cache
def _jax_step0_grad(style: int) -> np.ndarray:
    """The JAX sharded objective's whole gradient for one style at the
    step-0 images (a 1 x 2 mesh: one style's rows over 2 devices)."""
    targets, _ = _jax_dp_sp(ADAM)
    content = jnp.asarray(_inputs()[0])
    loss_fn = jax_spatial.make_spatial_loss(
        jax_mesh.create_mesh(n_style=1, n_space=2), tuple(content.shape),
        style_layers=STYLE, content_layers=CONTENT, precision=HIGHEST,
        **{k: v for k, v in _ADAM.items() if k not in ("optimizer", "lr")},
    )
    one = jax_features.Targets(
        style_grams={
            k: jnp.asarray(v[style]) for k, v in targets["grams"].items()
        },
        content_feats={
            k: jnp.asarray(v[style]) for k, v in targets["feats"].items()
        },
    )
    grad = jax.jit(jax.grad(
        lambda v: loss_fn(_jax_params(), v, one)[0],
    ))(jnp.asarray(_start(ADAM)[style]))
    return np.asarray(grad)


def _case(name: str, targets: dict, kwargs: dict) -> dict:
    return {
        **targets, "shape": (1, SIZE, SIZE, 3), "images": _start(name),
        "style_layers": STYLE, "content_layers": CONTENT,
        "kwargs": kwargs, "steps": STEPS,
    }


# --- the 2 x 2 mesh ----------------------------------------------------


@pytest.fixture(scope="module")
def dp_sp():
    """World rank 0's results of one spawn of a 2 x 2 mesh."""
    cases = {
        "step0": _case(ADAM, _jax_dp_sp(ADAM)[0], dict(_ADAM)),
        "trajectories": {
            ADAM: _case(ADAM, _jax_dp_sp(ADAM)[0], dict(_ADAM)),
            **{
                name: _case(name, _whole_targets(), kwargs)
                for name, kwargs in LBFGS_CASES.items()
            },
        },
    }
    return mesh.launch(
        torch_batch_workers.step_battery, (cases,), 2, "cpu", n_style=2,
        timeout=TIMEOUT, deadline=DEADLINE,
    )


def test_ranks_lie_on_the_jax_grid(dp_sp) -> None:
    assert dp_sp["axes"] == (2, 2)
    layout = dp_sp["layout"]
    assert layout.shape == (2, 2, 3)
    for s in range(2):
        for i in range(2):
            assert tuple(layout[s, i]) == (s, i, int(s == 0 and i == 0))


def test_step0_matches_jax_per_style(dp_sp) -> None:
    got = dp_sp["step0"]
    _, traj = _jax_dp_sp(ADAM)
    # The first step's metrics are the loss at the starting images.
    ref = traj[0][1]
    for ours, key in (
        (got["loss"], "loss"), (got["style"], "style_score"),
        (got["content"], "content_score"),
    ):
        np.testing.assert_allclose(ours, ref[key], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["aux_loss"], got["loss"])
    for s in range(2):
        want = _jax_step0_grad(s)
        err = np.abs(got["grad"][s] - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL, (s, err)


def test_adam_trajectory_matches_jax_dp_sp(dp_sp) -> None:
    got = dp_sp[ADAM]
    _, traj = _jax_dp_sp(ADAM)
    for step, (images, aux) in enumerate(traj):
        np.testing.assert_allclose(
            got["images"][step], images, rtol=IMAGE_RTOL, atol=IMAGE_ATOL,
        )
        np.testing.assert_allclose(
            got["loss"][step], aux["loss"], rtol=CURVE_RTOL,
        )


@functools.cache
def _torch_params():
    return vgg19.init_random_params(0, "cpu")


def _own_batch(name: str):
    """The port's single-process batch on the same targets and start:
    per-step images and losses."""
    targets = _whole_targets()
    bundle = multistyle.build_multi_style_update(
        _torch_params(),
        Targets(
            style_grams={
                k: torch.from_numpy(v) for k, v in targets["grams"].items()
            },
            content_feats={
                k: torch.from_numpy(v) for k, v in targets["feats"].items()
            },
        ),
        (1, SIZE, SIZE, 3), 2, style_layers=STYLE, content_layers=CONTENT,
        **LBFGS_CASES[name],
    )
    images, state = torch.from_numpy(_start(name)), bundle.opt_state
    out = []
    for _ in range(STEPS):
        images, state, aux = bundle.update_fn(images, state)
        out.append((images.numpy().copy(), aux.loss.numpy().copy()))
    return out


@pytest.mark.parametrize("name", list(LBFGS_CASES))
def test_lbfgs_trajectory_matches_single_device_and_own_batch(
    dp_sp, name,
) -> None:
    got = dp_sp[name]
    for s in range(2):
        for step, (x, loss) in enumerate(_jax_single(name, s)):
            np.testing.assert_allclose(
                got["images"][step][s], x, rtol=IMAGE_RTOL, atol=IMAGE_ATOL,
            )
            np.testing.assert_allclose(
                got["loss"][step][s], loss, rtol=CURVE_RTOL,
            )
    for step, (images, losses) in enumerate(_own_batch(name)):
        np.testing.assert_allclose(
            got["images"][step], images, rtol=LBFGS_RTOL, atol=LBFGS_RTOL,
        )
        np.testing.assert_allclose(got["loss"][step], losses, rtol=LBFGS_RTOL)


def test_dp_sp_step_is_eager_and_a_chunk_is_bit_equal(dp_sp) -> None:
    got = dp_sp[ADAM]
    assert got["eager"] is True
    np.testing.assert_array_equal(got["chunked"], got["images"][-1])
    np.testing.assert_array_equal(
        got["chunked_loss"], np.stack(got["loss"]),
    )


# --- a pure style axis (2 x 1) ------------------------------------------


def _host(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _dp_config(**opt) -> StyleTransferConfig:
    return StyleTransferConfig(
        optimization=OptimizationConfig(**{
            "steps": STEPS, "style_layers": [0, 5], "content_layers": [2],
            "allow_random_weights": True, "coarse_steps": 0,
            "lbfgs_history_size": 4, **opt,
        }),
        hardware=HardwareConfig(device="cpu"),
    )


DP_JOBS = {
    # A random start (each style's own draw of the whole batch's), warm
    # started, then the shipped L-BFGS with the TV and Laplacian terms.
    "lbfgs-every-term": {
        "init_method": "random", "coarse_steps": 2, "tv_w": 0.5,
        "lap_w": 1.0,
    },
}


def _dp_inputs():
    content = _host(11, (1, 64, 64, 3))
    styles = [_host(12, (1, 64, 64, 3)), _host(13, (1, 48, 80, 3))]
    return content, styles


@pytest.fixture(scope="module")
def dp_only():
    """World rank 0's results of one spawn of a 2 x 1 mesh."""
    content, styles = _dp_inputs()
    jobs = {
        name: (content, styles, _dp_config(**opt), STEPS)
        for name, opt in DP_JOBS.items()
    }
    return mesh.launch(
        torch_batch_workers.prepare_battery, (jobs,), 1, "cpu", n_style=2,
        timeout=TIMEOUT, deadline=DEADLINE,
    )


@pytest.mark.parametrize("name", list(DP_JOBS))
def test_style_axis_matches_the_single_process_batch(
    dp_only, name, monkeypatch,
) -> None:
    monkeypatch.setattr(
        conv3x3, "conv3x3_plain",
        torch_batch_workers.per_image(conv3x3.conv3x3_plain),
    )
    content, styles = _dp_inputs()
    # The ranks' thread count: CPU sums may split by it.
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    try:
        bundle, images = main.prepare_multi_style(
            content, styles, _dp_config(**DP_JOBS[name]),
        )
        start = images.numpy().copy()
        images, state, _ = bundle.chunked_update_fn(
            images, bundle.opt_state, STEPS,
        )
    finally:
        torch.set_num_threads(threads)
    got = dp_only[name]
    assert got["eager"] is False
    np.testing.assert_allclose(got["start"], start, rtol=0, atol=SAME_ATOL)
    np.testing.assert_allclose(
        got["images"], images.numpy(), rtol=0, atol=SAME_ATOL,
    )
    for field, ours in got["state"].items():
        ref = getattr(state, field).float().numpy()
        assert ours.shape == ref.shape, field
        np.testing.assert_allclose(
            ours, ref, rtol=SAME_ATOL, atol=SAME_ATOL, err_msg=field,
        )


# --- the entry point over 2 x 2: against JAX, and resume -------------------


_RUN_OPT = {
    "style_layers": [0, 5], "content_layers": [2], "init_method": "content",
    "allow_random_weights": True, "coarse_steps": 0,
}


def _run_config(out: Path, shards: int, steps: int, output=None, **opt):
    return StyleTransferConfig(
        output=OutputConfig(
            output=str(out), log_every=1, plot_losses=False,
            log_loss=str(out / "l.csv"), **(output or {}),
        ),
        optimization=OptimizationConfig(**{**_RUN_OPT, "steps": steps, **opt}),
        video=VideoConfig(create_video=False),
        hardware=HardwareConfig(device="cpu", spatial_shards=shards),
    )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded noise PNGs: a 64x64 content and styles of two sizes."""
    root = tmp_path_factory.mktemp("batch_mesh_inputs")
    rng = np.random.default_rng(44)
    paths = {}
    for name, (h, w) in (
        ("c", (64, 64)), ("s1", (72, 96)), ("s2", (64, 64)),
    ):
        paths[name] = root / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    """``(root, world rank 0's saved paths)``: every 2 x 2 run of the
    entry point, in one spawn."""
    root = tmp_path_factory.mktemp("batch_mesh_runs")
    content = str(files["c"])
    styles = [str(files["s1"]), str(files["s2"])]
    part = root / "part"
    jobs = {
        "e2e": (content, styles, _run_config(
            root / "e2e", 2, 3, optimizer="adam", lr=0.05,
        )),
        "whole_run": (content, styles, _run_config(
            root / "whole_run", 2, 4, output={"checkpoint_every": 2},
        )),
        "part": (content, styles, _run_config(
            part, 2, 2, output={"checkpoint_every": 2},
        )),
        "resumed": (content, styles, _run_config(part, 2, 4, output={
            "checkpoint_every": 2,
            "resume_from": str(part / "checkpoint.npz"),
            "checkpoint_path": str(part / "end.npz"),
        })),
    }
    out = mesh.launch(
        torch_batch_workers.run_battery, (jobs,), 2, "cpu", n_style=2,
        timeout=TIMEOUT, deadline=DEADLINE,
    )
    return root, out


def _csv_rows(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["step", "style_loss", "content_loss", "total_loss"]
    return np.array(rows[1:], dtype=np.float64)


def test_entry_point_over_2x2_matches_jax(tmp_path, runs, files) -> None:
    root, out = runs
    ref_dir = tmp_path / "ref"
    jax_cfg = JaxConfig.model_validate({
        "optimization": {
            "steps": 3, "optimizer": "adam", "lr": 0.05, **_RUN_OPT,
        },
        "hardware": {"device": "cpu", "spatial_shards": 2},
        "output": {
            "output": str(ref_dir), "log_every": 1, "plot_losses": False,
            "log_loss": str(ref_dir / "l.csv"),
        },
        "video": {"create_video": False},
    })
    ref_saved = jax_main.multi_style_transfer(
        str(files["c"]), [str(files["s1"]), str(files["s2"])], jax_cfg,
    )
    assert [Path(p).name for p in out["e2e"]] == [
        p.name for p in ref_saved
    ] == ["stylized_c_x_s1.png", "stylized_c_x_s2.png"]
    for style in ("s1", "s2"):
        name = f"stylized_c_x_{style}.png"
        ssim, mad = goldens_lib.compare(root / "e2e" / name, ref_dir / name)
        assert ssim >= goldens_lib.SSIM_MIN, (name, ssim)
        assert mad <= goldens_lib.MAD_MAX, (name, mad)
        got = _csv_rows(root / "e2e" / f"l_{style}.csv")
        want = _csv_rows(ref_dir / f"l_{style}.csv")
        np.testing.assert_array_equal(got[:, 0], [1, 2, 3])
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)


def test_2x2_resume_is_bit_equal_and_loads_single_process(
    tmp_path, runs, files,
) -> None:
    root, _ = runs
    with (
        np.load(root / "whole_run" / "checkpoint.npz") as a,
        np.load(root / "part" / "end.npz") as b,
    ):
        assert a.files == b.files
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    for style in ("s1", "s2"):
        png = f"stylized_c_x_{style}.png"
        assert np.array_equal(
            np.asarray(Image.open(root / "whole_run" / png)),
            np.asarray(Image.open(root / "part" / png)),
        )
    # The 2 x 2 checkpoint has the single-process batch's layout.
    single = _run_config(tmp_path, 1, 4, output={
        "resume_from": str(root / "part" / "checkpoint.npz"),
    })
    saved = main.multi_style_transfer(
        str(files["c"]), [str(files["s1"]), str(files["s2"])], single,
    )
    for path in saved:
        ssim, mad = goldens_lib.compare(path, root / "whole_run" / path.name)
        assert ssim >= goldens_lib.SSIM_MIN, (path.name, ssim)
        assert mad <= goldens_lib.MAD_MAX, (path.name, mad)
    assert _csv_rows(tmp_path / "l_s1.csv")[:, 0].tolist() == [3, 4]


# --- the CLI, the mesh, the cards -----------------------------------------


def test_cli_runs_styles_over_a_style_x_space_mesh(tmp_path, files) -> None:
    out = tmp_path / "cli"
    assert cli.main([
        "--content", str(files["c"]),
        "--styles", f"{files['s1']},{files['s2']}",
        "--spatial-shards", "2", "--device", "cpu", "--steps", "2",
        "--style-layers", "0,5", "--content-layers", "2",
        "--final-only", "--no-plot", "--allow-random-weights",
        "--log-every", "1", "--log-loss", str(out / "l.csv"),
        "--output", str(out),
    ]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "l_s1.csv", "l_s2.csv", "stylized_c_x_s1.png", "stylized_c_x_s2.png",
    ]
    for style in ("s1", "s2"):
        rows = _csv_rows(out / f"l_{style}.csv")
        assert rows[:, 0].tolist() == [1, 2]
        assert np.all(np.isfinite(rows))


def test_a_mesh_without_a_card_raises(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mesh.create_mesh(n_style=2, n_space=2)


def test_too_few_cards_for_the_mesh_are_refused(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(
        ValueError, match=r"A 2 \(style\) x 2 \(space\) mesh needs 4 cuda "
        r"devices; 3 attached\.",
    ):
        mesh.launch(print, (), 2, "cuda", n_style=2)


def test_spatial_shards_must_divide_the_cards(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    config = _run_config(tmp_path, 2, 1)
    config.hardware.device = "cuda"
    with pytest.raises(
        ValueError,
        match="--spatial-shards 2 must divide the 3 attached cuda devices",
    ):
        main.batch_layout(config, 2)


@pytest.mark.parametrize(
    ("device", "cards", "shards", "n_styles", "layout"),
    [
        ("cuda", 4, 1, 4, (4, 1)), ("cuda", 4, 2, 4, (2, 2)),
        ("cuda", 4, 1, 3, (3, 1)), ("cuda", 4, 2, 3, (1, 2)),
        ("cuda", 1, 1, 4, (1, 1)), ("cuda", 8, 2, 6, (3, 2)),
        ("cuda:1", 4, 1, 4, (1, 1)),
        ("cpu", 0, 1, 4, (1, 1)), ("cpu", 0, 2, 2, (2, 2)),
        ("cpu", 0, 4, 3, (3, 4)),
    ],
)
def test_batch_layout_is_the_jax_rule(
    tmp_path, monkeypatch, device, cards, shards, n_styles, layout,
) -> None:
    """The style axis: the largest divisor of S within the cards the
    space axis leaves (``torch.cuda.device_count()`` on ``cuda``, one
    on a named card, S x shards ranks on the CPU when sharded, one
    process otherwise)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(main, "setup_device", lambda name: name)
    config = _run_config(tmp_path, shards, 1)
    config.hardware.device = device
    assert main.batch_layout(config, n_styles) == layout
