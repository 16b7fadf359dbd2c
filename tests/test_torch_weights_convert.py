"""The port's weight conversion from a torchvision ``.pth``, on the CPU.

No VGG weights are on disk, so each test makes a seeded synthetic state
dict of the model's full widths (numpy draws) and saves it with
``torch.save``:

- ``_convert_checkpoint`` of the port gives host params bit-equal to the
  JAX package's ``convert_torch_state_dict`` (and its own
  ``_convert_checkpoint``), for VGG19 and VGG16, with the bare ``{i}``
  keys of a ``.features`` dump and the ``features.{i}`` keys of a whole
  model (whose other keys are ignored);
- the ``.npz`` cache is shared: an archive written by either package
  loads bit-equal in the other;
- ``_find_torch_checkpoint`` finds the file under ``$TORCH_HOME``, and
  ``load_pretrained_params`` takes the order cache -> ``.pth`` (then
  cached) -> seeded weights (only when allowed);
- a missing layer raises ``KeyError``, a wrong shape ``ValueError``;
- ``tools/fetch_weights.py`` exits 0 when it converts (or the cache is
  there) and 1 when no ``.pth`` is present.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.models import arch as jax_arch
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu_torch.models import arch, vgg19
from style_transfer_visualizer_tpu_torch.tools import fetch_weights


def _state_dict(model: arch.Architecture, prefix: str, seed: int = 0):
    """Seeded OIHW weights and biases of every conv of ``model``."""
    rng = np.random.default_rng(seed)
    state = {}
    for idx in model.conv_indices:
        _, c_in, c_out = model.layer_table[idx]
        state[f"{prefix}{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((c_out, c_in, 3, 3)).astype(np.float32),
        )
        state[f"{prefix}{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(c_out).astype(np.float32),
        )
    if prefix:
        state["classifier.0.weight"] = torch.zeros((4, 8))
    return state


def _assert_host_equal(ours, ref) -> None:
    assert sorted(ours) == sorted(ref)
    for idx, layer in ref.items():
        for key in ("w", "b"):
            mine, theirs = ours[idx][key], np.asarray(layer[key])
            assert mine.dtype == theirs.dtype == np.float32
            assert np.array_equal(mine, theirs), (idx, key)


@pytest.mark.parametrize("name", ["vgg19", "vgg16"])
@pytest.mark.parametrize("prefix", ["", "features."])
def test_pth_converts_like_jax(tmp_path, name, prefix) -> None:
    model = arch.get_architecture(name)
    state = _state_dict(model, prefix)
    path = tmp_path / f"{name}-0000.pth"
    torch.save(state, path)
    ours = vgg19._convert_checkpoint(path, model)  # noqa: SLF001
    jax_model = jax_arch.get_architecture(name)
    ref = jax_vgg19.convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, jax_model,
    )
    _assert_host_equal(ours, ref)
    _assert_host_equal(
        ours, jax_vgg19._convert_checkpoint(path, jax_model),  # noqa: SLF001
    )
    first = model.conv_indices[0]
    assert np.array_equal(
        ours[first]["w"],
        state[f"{prefix}{first}.weight"].numpy().transpose(2, 3, 1, 0),
    )


def test_the_npz_cache_is_shared_both_ways(tmp_path) -> None:
    host = vgg19.init_random_host_params(3, arch.VGG16)
    vgg19.save_params_npz(host, tmp_path / "ours.npz")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ours.npz"]
    _assert_host_equal(
        {i: {k: np.asarray(v) for k, v in layer.items()}
         for i, layer in jax_vgg19.load_params_npz(
             tmp_path / "ours.npz").items()},
        host,
    )
    jax_vgg19.save_params_npz(
        jax_vgg19.init_random_params(5, arch=jax_arch.VGG16),
        tmp_path / "jax.npz",
    )
    _assert_host_equal(
        vgg19.params_to_numpy(
            vgg19.load_params_npz(tmp_path / "jax.npz", "cpu"),
        ),
        vgg19.init_random_host_params(5, arch.VGG16),
    )


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """An empty torch hub directory under ``$TORCH_HOME``, and a home
    directory without one."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    directory = tmp_path / "torch" / "hub" / "checkpoints"
    directory.mkdir(parents=True)
    return directory


def test_find_torch_checkpoint_under_torch_home(hub) -> None:
    for name in ("vgg19", "vgg16"):
        assert arch.get_architecture(name).checkpoint_globs == (
            jax_arch.get_architecture(name).checkpoint_globs
        )
    assert vgg19._find_torch_checkpoint(arch.VGG19) is None  # noqa: SLF001
    (hub / "vgg16-397923af.pth").write_bytes(b"")
    assert vgg19._find_torch_checkpoint(arch.VGG19) is None  # noqa: SLF001
    (hub / "vgg19-dcbb9e9d.pth").write_bytes(b"")
    assert vgg19._find_torch_checkpoint(arch.VGG19) == (  # noqa: SLF001
        hub / "vgg19-dcbb9e9d.pth"
    )
    find_jax = jax_vgg19._find_torch_checkpoint  # noqa: SLF001
    assert find_jax(jax_arch.VGG19) == hub / "vgg19-dcbb9e9d.pth"


def test_load_pretrained_params_order(tmp_path, hub) -> None:
    cache = tmp_path / "cache"
    model = arch.VGG16
    # Nothing: seeded weights only when allowed.
    with pytest.raises(FileNotFoundError, match="stv-fetch-weights-torch"):
        vgg19.load_pretrained_params("cpu", arch=model, cache_dir=cache)
    seeded = vgg19.load_pretrained_params(
        "cpu", arch=model, cache_dir=cache, allow_random=True, seed=2,
    )
    _assert_host_equal(
        vgg19.params_to_numpy(seeded),
        vgg19.init_random_host_params(2, model),
    )
    # A .pth: converted, returned and cached.
    state = _state_dict(model, "features.", seed=8)
    torch.save(state, hub / "vgg16-397923af.pth")
    converted = vgg19.params_to_numpy(
        vgg19.load_pretrained_params("cpu", arch=model, cache_dir=cache),
    )
    want = jax_vgg19.convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, jax_arch.VGG16,
    )
    _assert_host_equal(converted, want)
    assert (cache / model.cache_filename).is_file()
    # The cache wins over the .pth.
    vgg19.save_params_npz(vgg19.init_random_host_params(9, model),
                          cache / model.cache_filename)
    cached = vgg19.params_to_numpy(
        vgg19.load_pretrained_params("cpu", arch=model, cache_dir=cache),
    )
    _assert_host_equal(cached, vgg19.init_random_host_params(9, model))


def test_missing_layer_and_wrong_shape_raise() -> None:
    state = {k: v.numpy() for k, v in _state_dict(arch.VGG16, "").items()}
    missing = dict(state)
    del missing["28.bias"]
    with pytest.raises(KeyError, match="missing conv layer 28"):
        vgg19.convert_torch_state_dict(missing, arch.VGG16)
    wrong = dict(state)
    wrong["2.weight"] = np.zeros((64, 32, 3, 3), np.float32)
    with pytest.raises(ValueError, match="Layer 2: expected OIHW"):
        vgg19.convert_torch_state_dict(wrong, arch.VGG16)


def test_fetch_weights_tool(tmp_path, hub) -> None:
    cache = tmp_path / "cache"
    argv = ["--model", "vgg16", "--checkpoint-dir", str(hub),
            "--cache-dir", str(cache)]
    assert fetch_weights.main(argv) == 1
    assert not cache.exists()
    state = _state_dict(arch.VGG16, "", seed=4)
    torch.save(state, hub / "vgg16-397923af.pth")
    assert fetch_weights.main(argv) == 0
    npz = cache / arch.VGG16.cache_filename
    want = jax_vgg19.convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, jax_arch.VGG16,
    )
    _assert_host_equal(
        vgg19.params_to_numpy(vgg19.load_params_npz(npz, "cpu")), want,
    )
    # Cached: nothing to do; --force looks for the .pth again.
    (hub / "vgg16-397923af.pth").unlink()
    assert fetch_weights.main(argv) == 0
    assert fetch_weights.main([*argv, "--force"]) == 1
