"""The port's regional (masked) transfer vs the JAX package's, on the CPU.

With the same seeded weights and numpy inputs:

- ``load_region_masks``: bit-equal (the same Pillow steps and float32
  numpy on both sides), and the same refusal of an empty mask;
- ``masked_gram``, forward and gradient, with feathered, partition and
  all-ones masks at 2:1, 4:1, same-size and odd ratios: within 1e-5
  relative (of the largest magnitude for the gradient); an all-ones
  mask gives the stock ``ops.gram.gram_matrix`` bit for bit, at the
  ratios of the 64x64 and 1280x720 stacks (the scale is exactly 1);
- ``regional_style_loss`` and the whole regional objective with its
  gradient: within 1e-5;
- ``stylize_regional`` end to end at 64x64 with Adam: the per-step loss
  curve (a CSV row a step) within 1e-3 relative of the JAX run's, the
  PNG ``regional_{content}_x_{s0+s1}.png`` within 2 uint8 levels, plain
  and with the TV and Laplacian terms, per-layer weights and luminance
  color; and the JAX package's refusals.
"""
from __future__ import annotations

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import style_transfer_visualizer_tpu.regional as jax_regional
from style_transfer_visualizer_tpu import image_io as jax_image_io
from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu_torch import image_io, regional
from style_transfer_visualizer_tpu_torch.models import features, vgg19
from style_transfer_visualizer_tpu_torch.ops.gram import gram_matrix
from tests import goldens_lib
from tests.torch_pipelines import (
    CURVE_RTOL,
    assert_pngs_close,
    jax_config,
    port_config,
)

RTOL = 1e-5
STYLE, CONTENT = (0, 5), (2,)


def _mask_png(path: Path, arr: np.ndarray) -> Path:
    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)
    return path


def _masks(kind: str, h: int = 48, w: int = 40) -> list[np.ndarray]:
    """Two uint8 masks of one kind."""
    cols = np.arange(w)[None, :].repeat(h, axis=0)
    if kind == "halves":
        left = np.where(cols < w // 2, 255, 0)
        return [left, 255 - left]
    if kind == "feathered":
        ramp = np.clip((cols - (w // 2 - 8)) * 255 / 16, 0, 255)
        return [255 - ramp, ramp]
    if kind == "overlap":
        a = np.where(cols < 3 * w // 4, 200, 0)
        b = np.where(cols >= w // 4, 100, 0)
        return [a, b]
    if kind == "uncovered":
        a = np.where(cols < w // 3, 255, 0)
        b = np.where(cols >= 2 * w // 3, 255, 0)
        return [a, b]
    msg = kind
    raise ValueError(msg)


@pytest.mark.parametrize(
    "kind", ["halves", "feathered", "overlap", "uncovered"],
)
@pytest.mark.parametrize("size", [(48, 40), (64, 64), (31, 57)])
def test_load_region_masks_bit_equal(tmp_path, kind, size) -> None:
    paths = [
        _mask_png(tmp_path / f"m{i}.png", m)
        for i, m in enumerate(_masks(kind))
    ]
    ours = regional.load_region_masks(paths, *size)
    ref = np.asarray(jax_regional.load_region_masks(paths, *size))
    assert ours.dtype == np.float32
    assert ours.shape == (2, *size)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours.sum(axis=0), 1.0, rtol=1e-6)


def test_empty_mask_refused_like_jax(tmp_path) -> None:
    good = _mask_png(tmp_path / "a.png", np.full((8, 8), 255))
    empty = _mask_png(tmp_path / "b.png", np.zeros((8, 8)))
    msgs = []
    for fn in (regional.load_region_masks, jax_regional.load_region_masks):
        with pytest.raises(ValueError) as exc:  # noqa: PT011
            fn([good, empty], 8, 8)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "empty" in msgs[0]


def _float_mask(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    if kind == "ones":
        return np.ones((h, w), np.float32)
    if kind == "partition":
        rng = np.random.default_rng(seed)
        return rng.uniform(size=(h, w)).astype(np.float32)
    return (_masks("feathered", h, w)[0] / 255.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["feathered", "partition", "ones"])
@pytest.mark.parametrize(
    ("mask_hw", "feat_hw"),
    [((64, 64), (32, 32)), ((64, 64), (16, 16)), ((64, 64), (64, 64)),
     ((63, 45), (21, 13)), ((45, 80), (23, 40))],
)
def test_masked_gram_and_grad_match_jax(kind, mask_hw, feat_hw) -> None:
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((1, *feat_hw, 16)).astype(np.float32)
    mask = _float_mask(kind, *mask_hw, seed=8)
    dg = rng.standard_normal((16, 16)).astype(np.float32)
    ft = torch.from_numpy(feats.copy()).requires_grad_(True)
    ours = regional.masked_gram(ft, torch.from_numpy(mask))
    (grad,) = torch.autograd.grad((ours * torch.from_numpy(dg)).sum(), ft)
    ref, vjp = jax.vjp(
        lambda f: jax_regional.masked_gram(f, jnp.asarray(mask)),
        jnp.asarray(feats),
    )
    (ref_grad,) = vjp(jnp.asarray(dg))
    ref, ref_grad = np.asarray(ref), np.asarray(ref_grad)
    np.testing.assert_allclose(
        ours.detach().numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(),
    )
    np.testing.assert_allclose(
        grad.numpy(), ref_grad, rtol=RTOL,
        atol=RTOL * np.abs(ref_grad).max(),
    )


@pytest.mark.parametrize(
    ("mask_hw", "feat_hw"),
    [((64, 64), (64, 64)), ((64, 64), (32, 32)), ((64, 64), (4, 4)),
     ((720, 1280), (360, 640)), ((720, 1280), (180, 320)),
     ((720, 1280), (90, 160)), ((720, 1280), (45, 80))],
)
def test_all_ones_mask_is_the_stock_gram(mask_hw, feat_hw) -> None:
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(
        rng.standard_normal((1, *feat_hw, 8)).astype(np.float32),
    )
    masked = regional.masked_gram(feats, torch.ones(mask_hw))
    assert torch.equal(masked, gram_matrix(feats))


@pytest.fixture(scope="module")
def vgg_pair():
    return (
        jax_vgg19.init_random_params(jax.random.key(0)),
        vgg19.init_random_params(0, "cpu"),
    )


def _regional_targets(vgg_pair, masks: np.ndarray):
    """The same RegionalTargets in both packages, 32x32."""
    params_j, params_t = vgg_pair
    rng = np.random.default_rng(11)
    content, s1, s2 = (
        rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
        for _ in range(3)
    )
    norm_j = jax_image_io.normalize_image
    ref_t = [
        jax_features.compute_targets(
            params_j, norm_j(jnp.asarray(s)), norm_j(jnp.asarray(content)),
            STYLE, CONTENT if i == 0 else (),
        )
        for i, s in enumerate((s1, s2))
    ]

    def dev(a):
        return image_io.host_array_to_device(a, "cpu", normalize=True)

    ours_t = [
        features.compute_targets(
            params_t, dev(s), dev(content), STYLE, CONTENT if i == 0 else (),
        )
        for i, s in enumerate((s1, s2))
    ]
    ref = jax_regional.RegionalTargets(
        style_grams=[t.style_grams for t in ref_t],
        content_feats=ref_t[0].content_feats,
        masks=jnp.asarray(masks),
    )
    ours = regional.RegionalTargets(
        style_grams=[t.style_grams for t in ours_t],
        content_feats=ours_t[0].content_feats,
        masks=torch.from_numpy(masks),
    )
    return ref, ours


def _partition(h: int = 32, w: int = 32) -> np.ndarray:
    left = (_masks("feathered", h, w)[0] / 255.0).astype(np.float32)
    return np.stack([left, 1.0 - left])


@pytest.mark.parametrize("weights", [None, (1.0, 0.25)])
def test_regional_style_loss_matches_jax(vgg_pair, weights) -> None:
    params_j, params_t = vgg_pair
    ref_rt, ours_rt = _regional_targets(vgg_pair, _partition())
    x = np.random.default_rng(12).standard_normal(
        (1, 32, 32, 3),
    ).astype(np.float32)
    acts_j = jax_features.extract_features(params_j, jnp.asarray(x), STYLE)
    acts_t = features.extract_features(params_t, torch.from_numpy(x), STYLE)
    ref = float(jax_regional.regional_style_loss(
        acts_j, ref_rt, STYLE, style_weights=weights,
    ))
    ours = float(regional.regional_style_loss(
        acts_t, ours_rt, STYLE, style_weights=weights,
    ))
    np.testing.assert_allclose(ours, ref, rtol=RTOL)


@pytest.mark.parametrize(
    "opt",
    [{}, {"tv_w": 0.5, "lap_w": 10.0, "lap_pool": 2,
          "style_layer_weights": [1.0, 0.5]}],
    ids=["plain", "tv-lap-weights"],
)
def test_regional_objective_and_grad_match_jax(
    vgg_pair, tmp_path, opt,
) -> None:
    from style_transfer_visualizer_tpu.ops.lap import (  # noqa: PLC0415
        lap_response as jax_lap_response,
    )
    from style_transfer_visualizer_tpu_torch.ops.lap import (  # noqa: PLC0415
        lap_response,
    )

    params_j, params_t = vgg_pair
    ref_rt, ours_rt = _regional_targets(vgg_pair, _partition())
    x = np.random.default_rng(13).standard_normal(
        (1, 32, 32, 3),
    ).astype(np.float32)
    if opt.get("lap_w"):
        ref_rt = (ref_rt, jax_lap_response(jnp.asarray(x) * 0.5, 2))
        ours_rt = (ours_rt, lap_response(torch.from_numpy(x) * 0.5, 2))
    ref_fn = jax_regional.make_regional_loss(jax_config(tmp_path, **opt))
    our_fn = regional.make_regional_loss(port_config(tmp_path, **opt))
    (ref, (ref_s, ref_c)), ref_g = jax.value_and_grad(
        lambda im: ref_fn(params_j, im, ref_rt), has_aux=True,
    )(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    ours, (s, c) = our_fn(params_t, xt, ours_rt)
    (g,) = torch.autograd.grad(ours, xt)
    for mine, theirs in ((ours, ref), (s, ref_s), (c, ref_c)):
        np.testing.assert_allclose(
            float(mine.detach()), float(theirs), rtol=RTOL,
        )
    ref_g = np.asarray(ref_g)
    assert np.abs(g.numpy() - ref_g).max() <= 1e-4 * np.abs(ref_g).max()


# --- end to end ------------------------------------------------------------


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    root = tmp_path / "in"
    corpus = goldens_lib.write_inputs(root)
    feathered = _masks("feathered", 64, 64)
    return corpus._replace(
        mask1=_mask_png(root / "f1.png", feathered[0]),
        mask2=_mask_png(root / "f2.png", feathered[1]),
    )


def _curve(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    return np.array(rows[1:], dtype=np.float64)


@pytest.mark.parametrize(
    "opt",
    [{}, {"tv_w": 0.1, "lap_w": 10.0, "lap_pool": 2,
          "style_layer_weights": [1.0, 0.5],
          "preserve_color": "luminance"}],
    ids=["plain", "tv-lap-weights-luminance"],
)
def test_regional_run_matches_jax(tmp_path, inputs, opt) -> None:
    styles = [inputs.style1, inputs.style2]
    masks = [inputs.mask1, inputs.mask2]
    results = {}
    for name, module, make in (
        ("ours", regional, port_config), ("ref", jax_regional, jax_config),
    ):
        config = make(tmp_path / name, **opt)
        config.output.log_every = 1
        config.output.log_loss = str(tmp_path / f"{name}.csv")
        results[name] = module.stylize_regional(
            inputs.content, styles, masks, config,
        )
    ours, ref = results["ours"], results["ref"]
    assert ours.output_path.name == "regional_content_x_style1+style2.png"
    assert ours.output_path == tmp_path / "ours" / ref.output_path.name
    assert ours.total_steps == ref.total_steps == 3
    got, want = _curve(tmp_path / "ours.csv"), _curve(tmp_path / "ref.csv")
    np.testing.assert_array_equal(got[:, 0], [1, 2, 3])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)
    np.testing.assert_allclose(ours.final_loss, ref.final_loss, rtol=1e-3)
    assert_pngs_close(ours.output_path, ref.output_path)


@pytest.mark.parametrize("case", ["one-style", "mask-count", "missing-mask"])
def test_regional_refusals_match_jax(tmp_path, inputs, case) -> None:
    styles = [inputs.style1, inputs.style2]
    masks = [inputs.mask1, inputs.mask2]
    if case == "one-style":
        styles, masks = styles[:1], masks[:1]
    elif case == "mask-count":
        masks = masks[:1]
    else:
        masks = [inputs.mask1, tmp_path / "nope.png"]
    errors = []
    for module, make in ((regional, port_config), (jax_regional, jax_config)):
        with pytest.raises((ValueError, FileNotFoundError)) as exc:
            module.stylize_regional(
                inputs.content, styles, masks, make(tmp_path / "o"),
            )
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


def test_regional_timelapse_names(tmp_path, inputs) -> None:
    config = port_config(tmp_path / "out")
    config.video.final_only = False
    config.video.create_video = False
    config.video.create_gif = True
    config.video.save_every = 1
    result = regional.stylize_regional(
        inputs.content, [inputs.style1, inputs.style2],
        [inputs.mask1, inputs.mask2], config,
    )
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "regional_content_x_style1+style2.png",
        "timelapse_content_x_style1+style2.gif",
    ]
    assert np.isfinite(result.final_loss)
