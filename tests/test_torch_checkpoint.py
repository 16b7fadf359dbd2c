"""The port's checkpoints and resume, on the CPU.

- round trips of every optimizer state the port runs (Adam, L-BFGS with
  an f32 and a bf16 ring, the batched states at S = 2): every leaf,
  the image and the step come back bit-equal, with their dtypes;
- the refusals: a missing file, another leaf count (another
  optimizer), another leaf shape, and a checkpoint written by the JAX
  package's own ``save_checkpoint`` (another state layout);
- the ring's dtype cast between f32 and bf16, with its log line;
- the runner: a save at every ``checkpoint_every`` step and none
  without a path; a resumed run runs the remaining steps from
  ``start_step`` (single steps until a chunk is on the cadence grid),
  and a start past ``steps`` is clamped to it;
- bit-equality: a run of 6 steps and a run of 3 resumed to 6 end with
  the same image and the same optimizer state, bit for bit, and their
  loss CSVs hold the same rows, for the shipped L-BFGS and for Adam,
  single (through the CLI and a TOML) and batch at S = 2;
- against the JAX package: Adam, 3 steps, then resumed to 6, in both
  packages; the curves agree within the tolerance of the whole-objective
  Adam parity test (1e-3 relative, ``tests/test_torch_objective.py``).
  L-BFGS is held only against itself: the shipped fixed-step L-BFGS
  grows a rounding difference past 1e-3 within a few steps;
- the warm start is skipped on resume, single and batch.
"""
from __future__ import annotations

import csv
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu import main as jax_main
from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.engine.optimizers import (
    lbfgs_init as jax_lbfgs_init,
)
from style_transfer_visualizer_tpu.runtime.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from style_transfer_visualizer_tpu.type_defs import (
    InputPaths as JaxInputPaths,
)
from style_transfer_visualizer_tpu_torch import cli, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.engine import runner
from style_transfer_visualizer_tpu_torch.engine.optimizers import (
    AdamState,
    StepAux,
    adam_init,
    adam_init_batched,
    lbfgs_init,
    lbfgs_init_batched,
)
from style_transfer_visualizer_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger

# The whole-objective Adam parity tolerance (test_torch_objective.py).
CURVE_RTOL = 1e-3
_N = 4 * 4 * 3


@pytest.fixture
def log_records(monkeypatch, caplog):
    monkeypatch.setattr(logger, "propagate", True)
    caplog.set_level(logging.INFO, logger=logger.name)
    return caplog


def _filled(state, seed: int):
    """``state`` with every leaf replaced by seeded values of its dtype."""
    rng = np.random.default_rng(seed)
    leaves = {}
    for name in type(state).__dataclass_fields__:
        ref = getattr(state, name)
        if ref.dtype.is_floating_point:
            vals = torch.from_numpy(
                rng.standard_normal(tuple(ref.shape)).astype(np.float32),
            ).to(ref.dtype)
        else:
            vals = torch.from_numpy(
                rng.integers(0, 50, tuple(ref.shape)),
            ).to(ref.dtype)
        leaves[name] = vals
    return type(state)(**leaves)


def _states():
    return {
        "adam": adam_init((1, 4, 4, 3), "cpu"),
        "lbfgs_f32": lbfgs_init(_N, 5, "cpu"),
        "lbfgs_bf16": lbfgs_init(_N, 5, "cpu", torch.bfloat16),
        "lbfgs_batched": lbfgs_init_batched(2, _N, 5, "cpu", torch.bfloat16),
        "adam_batched": adam_init_batched((2, 1, 4, 4, 3), "cpu"),
    }


def _assert_state_equal(ours, ref) -> None:
    assert type(ours) is type(ref)
    for name in type(ref).__dataclass_fields__:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", list(_states()))
def test_round_trip(tmp_path, kind) -> None:
    like = _states()[kind]
    state = _filled(like, 1)
    batched = kind.endswith("batched")
    image = torch.from_numpy(
        np.random.default_rng(2).standard_normal(
            (2, 1, 4, 4, 3) if batched else (1, 4, 4, 3),
        ).astype(np.float32),
    )
    path = save_checkpoint(tmp_path / "ck.npz", 42, image, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    ckpt = load_checkpoint(path, like, "cpu")
    assert ckpt.step == 42
    assert torch.equal(ckpt.image, image)
    _assert_state_equal(ckpt.opt_state, state)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        assert meta["optimizer"] == ("adam" if "adam" in kind else "lbfgs")
        assert meta["layout"] == list(type(like).__dataclass_fields__)
        if "bf16" in kind or kind == "lbfgs_batched":
            assert meta["bf16_leaves"] == [0, 1]
            assert data["state_0"].dtype == np.uint16


def test_missing_file(tmp_path) -> None:
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        load_checkpoint(tmp_path / "none.npz", adam_init((1, 2, 2, 3), "cpu"),
                        "cpu")


def test_optimizer_mismatch(tmp_path) -> None:
    image = torch.zeros((1, 2, 2, 3))
    path = save_checkpoint(
        tmp_path / "ck.npz", 1, image, adam_init((1, 2, 2, 3), "cpu"),
    )
    with pytest.raises(ValueError, match="different optimizer"):
        load_checkpoint(path, lbfgs_init(12, 3, "cpu"), "cpu")


def test_shape_mismatch(tmp_path) -> None:
    image = torch.zeros((1, 4, 4, 3))
    path = save_checkpoint(tmp_path / "ck.npz", 3, image,
                           lbfgs_init(_N, 5, "cpu"))
    with pytest.raises(ValueError, match="incompatible configuration"):
        load_checkpoint(path, lbfgs_init(_N, 4, "cpu"), "cpu")


def test_a_jax_checkpoint_is_refused(tmp_path) -> None:
    path = jax_save_checkpoint(
        tmp_path / "jax.npz", 5, jnp.zeros((1, 4, 4, 3)),
        jax_lbfgs_init(_N, history_size=5),
    )
    with pytest.raises(ValueError, match="JAX package"):
        load_checkpoint(path, lbfgs_init(_N, 5, "cpu"), "cpu")


@pytest.mark.parametrize(
    ("saved", "resumed"),
    [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)],
)
def test_ring_dtype_is_cast(tmp_path, log_records, saved, resumed) -> None:
    state = _filled(lbfgs_init(_N, 5, "cpu", saved), 3)
    path = save_checkpoint(tmp_path / "ck.npz", 7, torch.zeros((1, 4, 4, 3)),
                           state)
    ckpt = load_checkpoint(path, lbfgs_init(_N, 5, "cpu", resumed), "cpu")
    for name in ("s_hist", "y_hist"):
        leaf = getattr(ckpt.opt_state, name)
        assert leaf.dtype == resumed
        assert torch.equal(leaf, getattr(state, name).to(resumed))
    assert torch.equal(ckpt.opt_state.rho, state.rho)
    cast = [r.getMessage() for r in log_records.records
            if r.getMessage().startswith("Casting checkpoint state leaf")]
    assert len(cast) == 2
    assert "s_hist" in cast[0] and str(resumed) in cast[0]


# --- the runner -------------------------------------------------------


class _Bar:
    def __init__(self) -> None:
        self.updates = 0

    def update(self, n: int = 1) -> None:
        self.updates += n

    def set_postfix(self, *args, **kwargs) -> None:
        del args, kwargs

    def close(self) -> None:
        pass


class _Scripted:
    """An update that adds 1 to every pixel and Adam's count."""

    def __init__(self) -> None:
        self.calls: list[int] = []

    def _aux(self) -> StepAux:
        one = torch.ones(())
        return StepAux(one, one, one, torch.ones((), dtype=torch.int64))

    def update(self, image, state):
        self.calls.append(1)
        state = AdamState(state.mu + 1, state.nu, state.count + 1)
        return image + 1, state, self._aux()

    def chunked(self, image, state, k):
        self.calls.append(k)
        state = AdamState(state.mu + k, state.nu, state.count + k)
        aux = self._aux()
        stacked = StepAux(*(torch.stack([getattr(aux, f)] * k) for f in (
            "loss", "style_score", "content_score", "n_evals")))
        return image + k, state, stacked


def _runner_config(steps, *, checkpoint_every=0, log_loss=None, log_every=10):
    return StyleTransferConfig(
        output=OutputConfig(
            checkpoint_every=checkpoint_every, log_loss=log_loss,
            log_every=log_every,
        ),
        optimization=OptimizationConfig(steps=steps),
        hardware=HardwareConfig(device="cpu"),
    )


def test_runner_saves_at_the_cadence(tmp_path, monkeypatch) -> None:
    saved = []
    real = runner.save_checkpoint

    def spy(path, step, image, state):
        saved.append(step)
        return real(path, step, image, state)

    monkeypatch.setattr(runner, "save_checkpoint", spy)
    script = _Scripted()
    path = tmp_path / "ck.npz"
    runner.OptimizationRunner(
        script.update, adam_init((1, 2, 2, 1), "cpu"),
        torch.zeros((1, 2, 2, 1)), _runner_config(5, checkpoint_every=2),
        progress_bar=_Bar(), checkpoint_path=path,
        chunked_update_fn=script.chunked,
    ).run()
    assert saved == [2, 4]
    ckpt = load_checkpoint(path, adam_init((1, 2, 2, 1), "cpu"), "cpu")
    assert ckpt.step == 4
    assert torch.equal(ckpt.image, torch.full((1, 2, 2, 1), 4.0))
    assert int(ckpt.opt_state.count) == 4
    # The chunks divide the checkpoint cadence.
    assert script.calls == [2, 2, 1]


def test_a_cadence_without_a_path_saves_nothing(monkeypatch) -> None:
    def refuse(*args):
        raise AssertionError(args)

    monkeypatch.setattr(runner, "save_checkpoint", refuse)
    script = _Scripted()
    runner.OptimizationRunner(
        script.update, adam_init((1, 2, 2, 1), "cpu"),
        torch.zeros((1, 2, 2, 1)), _runner_config(4, checkpoint_every=2),
        progress_bar=_Bar(),
    ).run()
    assert script.calls == [1, 1, 1, 1]


def test_runner_resumes_at_start_step(tmp_path) -> None:
    """Steps 4 to 8: one single step, then chunks on the CSV's grid."""
    script = _Scripted()
    bar = _Bar()
    csv_path = tmp_path / "l.csv"
    csv_path.write_text("step,style_loss,content_loss,total_loss\n2,1,1,1\n")
    image, _, _ = runner.OptimizationRunner(
        script.update, adam_init((1, 2, 2, 1), "cpu"),
        torch.zeros((1, 2, 2, 1)),
        _runner_config(8, log_loss=str(csv_path), log_every=2),
        progress_bar=bar, start_step=3,
        chunked_update_fn=script.chunked,
    ).run()
    assert bar.updates == 5
    assert script.calls == [1, 2, 2]
    assert torch.equal(image, torch.full((1, 2, 2, 1), 5.0))
    rows = [r[0] for r in csv.reader(csv_path.open())]
    assert rows == ["step", "2", "4", "6", "8"]


def test_start_step_is_clamped_to_steps(tmp_path) -> None:
    """A checkpoint past ``steps`` resumes at ``steps``: nothing runs."""
    rng = np.random.default_rng(4)
    content, style = (
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in "cs"
    )
    saved = torch.from_numpy(
        rng.standard_normal((1, 32, 32, 3)).astype(np.float32),
    )
    config = _cpu_config(3, "adam")
    path = save_checkpoint(
        tmp_path / "ck.npz", 9, saved, adam_init((1, 32, 32, 3), "cpu"),
    )
    config.output.resume_from = str(path)
    image, history = main.run_style_transfer(content, style, config)
    assert history["total_loss"] == []
    want = main.image_io.prepare_image_for_output(saved, normalize=True)
    assert torch.equal(image, want)


# --- resumed runs: bit-equal to uninterrupted ones --------------------


def _cpu_config(steps: int, optimizer: str) -> StyleTransferConfig:
    return StyleTransferConfig(
        output=OutputConfig(log_every=1, plot_losses=False),
        optimization=OptimizationConfig(
            steps=steps, optimizer=optimizer, lr=1.0 if optimizer ==
            "lbfgs" else 0.1, style_layers=[0, 5], content_layers=[2],
            init_method="content", allow_random_weights=True,
        ),
        video=VideoConfig(create_video=False, final_only=True),
        hardware=HardwareConfig(device="cpu"),
    )


@pytest.fixture
def images(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(30)
    paths = {}
    for name in ("content", "sa", "sb"):
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


def _rows(path):
    return list(csv.reader(path.open()))


def _assert_checkpoints_equal(a, b) -> None:
    with np.load(a) as x, np.load(b) as y:
        assert x.files == y.files
        for key in x.files:
            assert x[key].dtype == y[key].dtype, key
            assert np.array_equal(x[key], y[key]), key


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_single_resume_is_bit_equal(tmp_path, images, optimizer) -> None:
    toml = tmp_path / "run.toml"
    toml.write_text(
        "[optimization]\nsteps = 6\n"
        f'optimizer = "{optimizer}"\n'
        f'lr = {1.0 if optimizer == "lbfgs" else 0.1}\n'
        "style_layers = [0, 5]\ncontent_layers = [2]\n"
        'init_method = "content"\nallow_random_weights = true\n'
        '[hardware]\ndevice = "cpu"\n[video]\nfinal_only = true\n'
        "[output]\nlog_every = 1\ncheckpoint_every = 3\n",
    )
    base = ["--content", str(images["content"]), "--style",
            str(images["sa"]), "--config", str(toml)]

    def run(name, *extra):
        out = tmp_path / name
        assert cli.main([
            *base, "--output", str(out), "--log-loss", str(out / "l.csv"),
            *extra,
        ]) == 0
        return out

    whole = run("whole")
    part = run("part", "--steps", "3")
    resumed = run(
        "part", "--resume-from", str(part / "checkpoint.npz"),
        "--checkpoint-path", str(part / "end.npz"),
    )
    _assert_checkpoints_equal(whole / "checkpoint.npz", resumed / "end.npz")
    assert _rows(whole / "l.csv") == _rows(part / "l.csv")
    assert len(_rows(whole / "l.csv")) == 7
    png = "stylized_content_x_sa.png"
    assert np.array_equal(
        np.asarray(Image.open(whole / png)),
        np.asarray(Image.open(part / png)),
    )


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_batch_resume_is_bit_equal(tmp_path, images, optimizer) -> None:
    def run(name, steps, **out):
        config = _cpu_config(steps, optimizer)
        config.output.output = str(tmp_path / name)
        config.output.log_loss = str(tmp_path / name / "l.csv")
        config.output.checkpoint_every = 3
        for key, value in out.items():
            setattr(config.output, key, value)
        return main.multi_style_transfer(
            str(images["content"]), [str(images["sa"]), str(images["sb"])],
            config,
        )

    run("whole", 6)
    run("part", 3)
    run("part", 6, resume_from=str(tmp_path / "part" / "checkpoint.npz"),
        checkpoint_path=str(tmp_path / "part" / "end.npz"))
    _assert_checkpoints_equal(
        tmp_path / "whole" / "checkpoint.npz", tmp_path / "part" / "end.npz",
    )
    with np.load(tmp_path / "part" / "end.npz") as data:
        assert data["image"].shape == (2, 1, 64, 64, 3)
    for style in ("sa", "sb"):
        whole = _rows(tmp_path / "whole" / f"l_{style}.csv")
        assert whole == _rows(tmp_path / "part" / f"l_{style}.csv")
        assert [r[0] for r in whole] == ["step", *map(str, range(1, 7))]


def _jax_curve(tmp_path, images, name, steps, **out) -> None:
    cfg = JaxConfig.model_validate({})
    cfg.hardware.device = "cpu"
    cfg.output.output = str(tmp_path / name)
    cfg.output.log_every = 1
    cfg.output.log_loss = str(tmp_path / name / "l.csv")
    cfg.output.plot_losses = False
    cfg.output.checkpoint_every = 3
    for key, value in out.items():
        setattr(cfg.output, key, value)
    opt = cfg.optimization
    opt.steps, opt.optimizer, opt.lr = steps, "adam", 0.1
    opt.style_layers, opt.content_layers = [0, 5], [2]
    opt.init_method, opt.allow_random_weights = "content", True
    cfg.hardware.precision = "highest"
    cfg.video.create_video, cfg.video.final_only = False, True
    jax_main.style_transfer(
        JaxInputPaths(str(images["content"]), str(images["sa"])), cfg,
    )


def test_resumed_adam_curve_matches_jax(tmp_path, images) -> None:
    _jax_curve(tmp_path, images, "jax", 3)
    _jax_curve(tmp_path, images, "jax", 6,
               resume_from=str(tmp_path / "jax" / "checkpoint.npz"))
    for steps, extra in ((3, {}), (6, {
        "resume_from": str(tmp_path / "port" / "checkpoint.npz"),
    })):
        config = _cpu_config(steps, "adam")
        config.output.output = str(tmp_path / "port")
        config.output.log_loss = str(tmp_path / "port" / "l.csv")
        config.output.checkpoint_every = 3
        for key, value in extra.items():
            setattr(config.output, key, value)
        main.style_transfer(
            InputPaths(str(images["content"]), str(images["sa"])), config,
        )
    ours, ref = (
        np.array([row[1:] for row in _rows(tmp_path / d / "l.csv")[1:]],
                 dtype=np.float64)
        for d in ("port", "jax")
    )
    assert ours.shape == ref.shape == (6, 3)
    np.testing.assert_allclose(ours, ref, rtol=CURVE_RTOL)
    assert ours[-1, 2] < ours[0, 2]


# --- the warm start on resume ------------------------------------------------


@pytest.mark.parametrize("resume", [False, True])
def test_warm_start_is_skipped_on_resume(
    tmp_path, monkeypatch, log_records, resume,
) -> None:
    calls = []

    def fake_init(*args, **kwargs):
        calls.append(args)

    monkeypatch.setattr(main, "coarse_init", fake_init)
    monkeypatch.setattr(main, "multi_coarse_init", fake_init)
    rng = np.random.default_rng(5)
    content, s1, s2 = (
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in "abc"
    )
    params = {0: main.load_pretrained_params(
        "cpu", allow_random=True)[0]}
    config = _cpu_config(2, "adam")
    config.optimization.style_layers = [0]
    config.optimization.content_layers = [0]
    config.optimization.coarse_steps = 2
    if resume:
        config.output.resume_from = str(tmp_path / "ck.npz")
    main.prepare_model_and_input(content, s1, config, params=params)
    main.prepare_multi_style(content, [s1, s2], config, params=params)
    skipped = [r for r in log_records.records
               if r.getMessage() == "Coarse warm start skipped: resuming "
               "a checkpoint."]
    assert len(calls) == (0 if resume else 2)
    assert len(skipped) == (2 if resume else 0)


def test_profile_dir_writes_a_trace(tmp_path) -> None:
    """``profile_dir`` traces the single run's and the batch's loops."""
    rng = np.random.default_rng(6)
    content, s1, s2 = (
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in "abc"
    )
    config = _cpu_config(1, "adam")
    config.output.profile_dir = str(tmp_path / "single")
    main.run_style_transfer(content, s1, config)
    config = _cpu_config(1, "adam")
    config.output.profile_dir = str(tmp_path / "batch")
    bundle, images = main.prepare_multi_style(content, [s1, s2], config)
    main.run_multi_style_loop(bundle, images, config, tmp_path / "out",
                              ["a", "b"], progress_bar=_Bar())
    for name in ("single", "batch"):
        traces = list((tmp_path / name).glob("*.pt.trace.json"))
        assert len(traces) == 1, name
        assert json.loads(traces[0].read_text())["traceEvents"]
