"""The port's precision tiers vs the JAX package's, on the CPU.

- the policy table: for every tier and every conv index of VGG19 and
  VGG16, the port's level of the forward conv, the backward conv, the
  Gram's forward and backward equals the JAX package's ``lax.Precision``
  by name, and maps to the kernel mode of the one table
  (``ops.precision.KERNEL_MODES``); unknown names raise in both;
  ``MIXED`` is frozen and hashable; the cases of the JAX package's
  ``tests/test_precision_policy.py`` that need no ``jit``;
- the feature path hands each conv and Gram its mode: the modes the
  wrappers are called with, per layer, are the policy's; on the CPU
  every tier gives ``highest``'s losses and gradients bit for bit, and
  the fp32 plain conv is the JAX package's conv within 1e-5;
- config and CLI: ``hardware.precision`` from the TOML, ``--precision``
  through ``cli.main`` and ``style-sequence-torch`` give the JAX
  package's config at each tier; bad names are refused by both;
- slice parity: a 64x64 run (VGG19 to layer 5, Adam and L-BFGS, 6
  steps) through ``run_style_transfer`` at each tier against the JAX
  package's step at the same tier: every step's loss within 1e-3
  relative (the JAX curve gate) and the image within 2/255 (the
  goldens' level tolerance). On the CPU both packages compute fp32 at
  every tier, so the tier must not change the CPU path: the port's
  curves at the four tiers are bit-equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu import cli as jax_cli
from style_transfer_visualizer_tpu import config as jax_config
from style_transfer_visualizer_tpu.engine.step import (
    build_update_step as jax_build_update_step,
    resolve_precision as jax_resolve,
)
from style_transfer_visualizer_tpu.image_io import (
    normalize_image,
    prepare_image_for_output,
)
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.models.arch import VGG16 as JAX_VGG16
from style_transfer_visualizer_tpu.models.arch import VGG19 as JAX_VGG19
from style_transfer_visualizer_tpu.models.features import (
    compute_targets as jax_compute_targets,
)
from style_transfer_visualizer_tpu.ops import precision as jp
import style_transfer_visualizer_tpu.sequence as jax_seq
import style_transfer_visualizer_tpu.sequence_cli as jax_seq_cli
from style_transfer_visualizer_tpu_torch import cli, sequence_cli
from style_transfer_visualizer_tpu_torch import config as port_config
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.main import run_style_transfer
from style_transfer_visualizer_tpu_torch.models import features
from style_transfer_visualizer_tpu_torch.models.arch import VGG16, VGG19
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    init_random_params,
)
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram
from style_transfer_visualizer_tpu_torch.ops import precision as pp

TIERS = ("highest", "mixed", "high", "default")
JAX_LEVELS = {
    jax.lax.Precision.HIGHEST: "highest",
    jax.lax.Precision.HIGH: "high",
    jax.lax.Precision.DEFAULT: "default",
    None: None,
}


def _level(jax_precision) -> str | None:
    return JAX_LEVELS[jax_precision]


# ---- the policy table


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize(
    ("jax_arch", "arch"), [(JAX_VGG19, VGG19), (JAX_VGG16, VGG16)],
    ids=["vgg19", "vgg16"],
)
def test_policy_table_matches_jax(tier, jax_arch, arch) -> None:
    ours, ref = pp.resolve_precision(tier), jax_resolve(tier)
    assert jax_arch.conv_indices == arch.conv_indices
    for idx in arch.conv_indices:
        fwd = pp.conv_precision(ours, idx)
        bwd = pp.conv_bwd_precision(ours, idx)
        assert fwd == _level(jp.conv_precision(ref, idx)), idx
        assert bwd == _level(jp.conv_bwd_precision(ref, idx)), idx
        assert pp.kernel_mode(fwd) == pp.KERNEL_MODES[fwd]
        assert pp.kernel_mode(bwd) == pp.KERNEL_MODES[bwd]
    assert pp.gram_precision(ours) == _level(jp.gram_precision(ref))
    assert pp.gram_bwd_precision(ours) == _level(jp.gram_bwd_precision(ref))


def test_level_table_is_the_north_star_map() -> None:
    assert pp.KERNEL_MODES == {
        "highest": "ieee", "high": "tf32x3", "default": "tf32", None: "tf32",
    }
    assert set(pp.KERNEL_MODES.values()) == set(pp.MODES)
    with pytest.raises(ValueError, match="Unknown precision level"):
        pp.kernel_mode("bf16")


@pytest.mark.parametrize("name", ["bf16ish", "", "HIGHEST", "Mixed", "fp32"])
def test_unknown_tier_raises_in_both(name) -> None:
    with pytest.raises(ValueError, match="Unknown precision"):
        jax_resolve(name)
    with pytest.raises(ValueError, match="Unknown precision"):
        pp.resolve_precision(name)


def test_mixed_is_frozen_and_hashable() -> None:
    clone = pp.PrecisionPolicy(**{
        f.name: getattr(pp.MIXED, f.name)
        for f in dataclasses.fields(pp.PrecisionPolicy)
    })
    assert clone == pp.MIXED
    assert hash(clone) == hash(pp.MIXED)
    assert {pp.MIXED: 1}[clone] == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        pp.MIXED.gram = pp.HIGH  # type: ignore[misc]


def test_resolution_of_the_tiers() -> None:
    assert pp.resolve_precision("mixed") is pp.MIXED
    assert pp.resolve_precision("highest") == pp.HIGHEST
    assert pp.resolve_precision("high") == pp.HIGH
    assert pp.resolve_precision("default") == pp.DEFAULT
    assert pp.PRECISION_NAMES == TIERS


def test_mixed_overrides_first_two_blocks() -> None:
    for idx in (0, 2, 5, 7):
        assert pp.MIXED.conv(idx) == pp.HIGHEST
        assert pp.MIXED.conv_bwd(idx) == pp.HIGH
    for idx in (10, 12, 19, 21, 28):
        assert pp.MIXED.conv(idx) == pp.HIGH
        assert pp.MIXED.conv_bwd(idx) == pp.HIGH
    assert pp.MIXED.gram == pp.HIGHEST
    assert pp.MIXED.gram_bwd_or_mirror() == pp.HIGH


def test_helpers_pass_levels_through() -> None:
    assert pp.conv_precision(pp.HIGH, 0) == pp.HIGH
    assert pp.conv_precision(None, 28) is None
    assert pp.gram_precision(pp.HIGH) == pp.HIGH
    assert pp.gram_precision(None) is None
    assert pp.conv_bwd_precision(pp.HIGHEST, 0) == pp.HIGHEST
    assert pp.gram_bwd_precision(pp.DEFAULT) == pp.DEFAULT


def test_policy_fallbacks_like_jax() -> None:
    base = pp.PrecisionPolicy(conv_base=pp.HIGH)
    assert pp.gram_precision(base) == pp.HIGH
    assert base.gram_bwd_or_mirror() == pp.HIGH
    mirrored = pp.PrecisionPolicy(
        conv_base=pp.DEFAULT, gram=pp.HIGHEST,
        conv_overrides=((0, pp.HIGHEST),),
    )
    assert mirrored.gram_bwd_or_mirror() == pp.HIGHEST
    assert mirrored.conv_bwd(0) == pp.HIGHEST
    assert mirrored.conv_bwd(10) == pp.DEFAULT
    table = pp.PrecisionPolicy(
        conv_base=pp.DEFAULT, conv_bwd_overrides=((5, pp.HIGHEST),),
    )
    assert table.conv_bwd(5) == pp.HIGHEST
    assert table.conv_bwd(7) == pp.DEFAULT
    ref = jp.PrecisionPolicy(
        conv_base=jax.lax.Precision.DEFAULT,
        conv_bwd_overrides=((5, jax.lax.Precision.HIGHEST),),
    )
    assert [_level(ref.conv_bwd(i)) for i in (5, 7)] == [
        table.conv_bwd(i) for i in (5, 7)
    ]


# ---- the feature path hands each conv and Gram its mode


@pytest.mark.parametrize("tier", TIERS)
def test_features_call_each_wrapper_in_its_mode(tier, monkeypatch) -> None:
    params = init_random_params(0, "cpu")
    prec = pp.resolve_precision(tier)
    convs: list[tuple[str, str]] = []
    grams: list[tuple[str, str]] = []
    real_conv = features.conv3x3_bias_relu
    real_apply = gram._GramFn.apply  # noqa: SLF001

    def conv(*args, mode, bwd_mode):
        convs.append((mode, bwd_mode))
        return real_conv(*args, mode=mode, bwd_mode=bwd_mode)

    def gram_apply(flat, clamp, norm, mode, bwd_mode):
        grams.append((mode, bwd_mode))
        return real_apply(flat, clamp, norm, mode, bwd_mode)

    monkeypatch.setattr(features, "conv3x3_bias_relu", conv)
    monkeypatch.setattr(gram._GramFn, "apply", gram_apply)  # noqa: SLF001
    x = torch.rand((1, 16, 16, 3))
    targets = features.compute_targets(
        params, x, x, (0, 5, 10), (7,), precision=prec,
    )
    features.total_loss(
        params, x, targets, 1.0, 1.0, (0, 5, 10), (7,), precision=prec,
    )
    sweep = [i for i in VGG19.conv_indices if i <= 10]
    want_convs = [
        (pp.kernel_mode(pp.conv_precision(prec, i)),
         pp.kernel_mode(pp.conv_bwd_precision(prec, i)))
        for i in sweep
    ]
    content = want_convs[: len([i for i in sweep if i <= 7])]
    assert convs == want_convs + content + want_convs
    want_gram = (
        pp.kernel_mode(pp.gram_precision(prec)),
        pp.kernel_mode(pp.gram_bwd_precision(prec)),
    )
    assert grams == [want_gram] * 6


@pytest.mark.parametrize("tier", TIERS)
def test_cpu_path_ignores_the_tier(tier) -> None:
    """Every mode's wrapper computes fp32 on a CPU tensor: losses and
    gradients are those of ``highest`` bit for bit."""
    params = init_random_params(0, "cpu")
    rng = np.random.default_rng(3)
    style, content, x0 = (
        torch.from_numpy(rng.uniform(size=(1, 24, 24, 3)).astype(np.float32))
        for _ in range(3)
    )

    def loss_and_grad(name: str):
        prec = pp.resolve_precision(name)
        targets = features.compute_targets(
            params, style, content, (0, 5), (2,), precision=prec,
        )
        x = x0.clone().requires_grad_(True)
        total, _ = features.total_loss(
            params, x, targets, 1e5, 1.0, (0, 5), (2,), precision=prec,
        )
        total.backward()
        return total.detach(), x.grad

    total, grad = loss_and_grad(tier)
    ref_total, ref_grad = loss_and_grad("highest")
    assert torch.equal(total, ref_total)
    assert torch.equal(grad, ref_grad)


def test_ieee_plain_conv_is_the_jax_conv() -> None:
    """The fp32 plain conv (every tier's CPU path) is the JAX package's
    conv at ``HIGHEST`` on the CPU, within 1e-5 of its largest value."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    w9 = (rng.normal(size=(9, 6, 7)) * 0.3).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w9.reshape(3, 3, 6, 7)), (1, 1),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    ))
    ours = conv3x3.conv3x3_plain(
        torch.from_numpy(x), torch.from_numpy(w9), None, False, mode="ieee",
    ).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


# ---- config and CLI


def _write(tmp_path, text: str, name: str = "c.toml"):
    path = tmp_path / name
    path.write_text(text)
    return path


@pytest.mark.parametrize("tier", TIERS)
def test_toml_precision_loads_like_jax(tmp_path, tier) -> None:
    path = _write(
        tmp_path, f'[hardware]\ndevice = "cpu"\nprecision = "{tier}"\n',
    )
    ours = port_config.ConfigLoader.load(path)
    ref = jax_config.ConfigLoader.load(str(path))
    assert ours.hardware.precision == ref.hardware.precision == tier


def test_default_precision_is_jax_default() -> None:
    assert HardwareConfig().precision == "mixed"
    assert jax_config.HardwareConfig().precision == "mixed"


@pytest.mark.parametrize("bad", ['"bf16"', '"HIGH"', "3"])
def test_bad_toml_precision_raises_in_both(tmp_path, bad) -> None:
    path = _write(tmp_path, f"[hardware]\nprecision = {bad}\n")
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        jax_config.ConfigLoader.load(str(path))
    with pytest.raises(ValueError):  # noqa: PT011
        port_config.ConfigLoader.load(path)
    with pytest.raises(ValueError, match="precision"):
        HardwareConfig(precision="bf16")


@pytest.mark.parametrize("tier", TIERS)
def test_precision_flag_through_cli_main(tmp_path, monkeypatch, tier) -> None:
    """``--precision`` reaches the run's config through ``cli.main`` over
    a TOML that sets another tier, as the JAX CLI's merge gives it."""
    seen = {}

    def capture(paths, config, **kwargs):
        del paths, kwargs
        seen["config"] = config

    monkeypatch.setattr(cli, "style_transfer", capture)
    path = _write(tmp_path, '[hardware]\nprecision = "high"\n')
    argv = ["--content", "c.png", "--style", "s.png", "--config", str(path),
            "--precision", tier]
    assert cli.main(argv) == 0
    ref = jax_config.build_config_from_cli(
        vars(jax_cli.build_arg_parser().parse_args(argv)),
        base_config=jax_config.ConfigLoader.load(str(path)),
    )
    assert seen["config"].hardware.precision == ref.hardware.precision == tier


def test_untyped_precision_keeps_the_toml(tmp_path, monkeypatch) -> None:
    seen = {}
    monkeypatch.setattr(
        cli, "style_transfer",
        lambda _p, config, **_k: seen.setdefault("config", config),
    )
    path = _write(tmp_path, '[hardware]\nprecision = "default"\n')
    assert cli.main(
        ["--content", "c.png", "--style", "s.png", "--config", str(path)],
    ) == 0
    assert seen["config"].hardware.precision == "default"


@pytest.mark.parametrize("module", [cli, jax_cli], ids=["port", "jax"])
def test_bad_precision_flag_exits_2(module, capsys) -> None:
    parser = (
        module.build_parser() if module is cli
        else module.build_arg_parser()
    )
    with pytest.raises(SystemExit) as exc:
        parser.parse_args(
            ["--content", "c.png", "--style", "s.png", "--precision", "f16"],
        )
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_precision_flag_choices_match_jax() -> None:
    def choices(parser):
        return next(
            tuple(a.choices) for a in parser._actions  # noqa: SLF001
            if "--precision" in a.option_strings
        )

    assert choices(cli.build_parser()) == choices(
        jax_cli.build_arg_parser(),
    )
    assert choices(sequence_cli.build_parser()) == choices(
        jax_seq_cli.build_parser(),
    )


@pytest.mark.parametrize("tier", TIERS)
def test_sequence_cli_precision_like_jax(monkeypatch, tier) -> None:
    argv = ["--frames", "fr", "--style", "s.png", "--precision", tier]
    calls = {}

    def capture(key):
        def run(frames, style, cfg, out, **kw):
            del frames, style, out, kw
            calls[key] = cfg
            return jax_seq.SequenceResult(frame_paths=[], total_steps=0)

        return run

    monkeypatch.setattr(sequence_cli, "stylize_sequence", capture("ours"))
    monkeypatch.setattr(jax_seq_cli, "stylize_sequence", capture("ref"))
    monkeypatch.setenv("STV_NO_XLA_CACHE", "1")
    assert sequence_cli.main(argv) == 0
    assert jax_seq_cli.main(argv) == 0
    assert calls["ours"].hardware.precision == tier
    assert calls["ref"].hardware.precision == tier


def test_sequence_cli_bad_precision_exits_like_jax() -> None:
    argv = ["--frames", "fr", "--style", "s.png", "--precision", "fp8"]
    codes = []
    for module in (sequence_cli, jax_seq_cli):
        with pytest.raises(SystemExit) as exc:
            module.main(argv)
        codes.append(exc.value.code)
    assert codes == [2, 2]


# ---- slice parity at each tier

STYLE, CONTENT = (0, 5), (2,)
SIDE, STEPS = 64, 6


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return tuple(
        rng.uniform(size=(1, SIDE, SIDE, 3)).astype(np.float32)
        for _ in range(2)
    )


def _port_config(tmp_path, tier: str, optimizer: str) -> StyleTransferConfig:
    return StyleTransferConfig(
        output=OutputConfig(output=str(tmp_path / "out"), log_every=2),
        optimization=OptimizationConfig(
            steps=STEPS, allow_random_weights=True, init_method="content",
            optimizer=optimizer, lr=1.0 if optimizer == "lbfgs" else 0.1,
            style_layers=list(STYLE), content_layers=list(CONTENT),
        ),
        video=VideoConfig(create_video=False),
        hardware=HardwareConfig(device="cpu", precision=tier),
    )


@pytest.fixture(scope="module")
def port_runs(images, tmp_path_factory):
    content, style = images
    out = {}
    for optimizer in ("lbfgs", "adam"):
        for tier in TIERS:
            root = tmp_path_factory.mktemp(f"{optimizer}_{tier}")
            out[optimizer, tier] = run_style_transfer(
                content, style, _port_config(root, tier, optimizer),
            )
    return out


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
@pytest.mark.parametrize("tier", TIERS)
def test_slice_matches_jax_at_each_tier(
    images, port_runs, tier, optimizer,
) -> None:
    content, style = images
    image, history = port_runs[optimizer, tier]
    prec = jax_resolve(tier)
    params = jax_vgg19.init_random_params(jax.random.key(0))
    targets = jax_compute_targets(
        params, normalize_image(jnp.asarray(style)),
        normalize_image(jnp.asarray(content)), STYLE, CONTENT, prec,
    )
    bundle = jax_build_update_step(
        params, targets, content.shape, optimizer=optimizer,
        lr=1.0 if optimizer == "lbfgs" else 0.1, style_w=1e5,
        content_w=1.0, style_layers=STYLE, content_layers=CONTENT,
        precision=tier, lbfgs_history_size=100,
        lbfgs_history_dtype="bfloat16", lbfgs_direction="compact",
    )
    img, state = normalize_image(jnp.asarray(content)), bundle.opt_state
    ref = []
    for _ in range(STEPS):
        img, state, aux = bundle.update_fn(img, state)
        ref.append(float(aux.loss))
    np.testing.assert_allclose(history["total_loss"], ref, rtol=1e-3)
    ref_img = np.asarray(prepare_image_for_output(img, normalize=True))
    assert np.abs(image.numpy() - ref_img).max() <= 2 / 255
    # The tier does not change the CPU path.
    _, highest = port_runs[optimizer, "highest"]
    assert history["total_loss"] == highest["total_loss"]
