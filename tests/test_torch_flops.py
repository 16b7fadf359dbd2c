"""The port's FLOPs model (``utils/flops.py``) against the JAX package's.

``step_flops``, ``conv_flops`` and ``gram_flops`` are integers computed
from the layer tables, so the two packages must agree exactly: VGG19
and VGG16 with their shipped taps at 512x512, 1024x1024 and 720x1280,
and each term alone. ``audit_fields`` reports the same FLOPs and
TFLOP/s and its share of the H100's dense TF32 peak (495 TFLOP/s)
under ``mfu_pct``.
"""
from __future__ import annotations

import pytest

from style_transfer_visualizer_tpu.models import arch as jax_arch
from style_transfer_visualizer_tpu.utils import flops as jax_flops
from style_transfer_visualizer_tpu_torch.models import arch
from style_transfer_visualizer_tpu_torch.utils import flops

SIZES = [(512, 512), (1024, 1024), (720, 1280)]


@pytest.mark.parametrize("model", ["vgg19", "vgg16"])
@pytest.mark.parametrize(("height", "width"), SIZES)
def test_step_flops_equal_jax(model, height, width) -> None:
    ours = arch.get_architecture(model)
    ref = jax_arch.get_architecture(model)
    assert ours.layer_table == ref.layer_table
    got = flops.step_flops(
        ours.layer_table, height, width,
        ours.default_style_layers, ours.default_content_layers,
    )
    want = jax_flops.step_flops(
        ref.layer_table, height, width,
        ref.default_style_layers, ref.default_content_layers,
    )
    assert got == want
    assert got > 0


@pytest.mark.parametrize("model", ["vgg19", "vgg16"])
@pytest.mark.parametrize("max_tap", [0, 5, 21, 28, 40])
def test_conv_and_gram_flops_equal_jax(model, max_tap) -> None:
    table = arch.get_architecture(model).layer_table
    assert flops.conv_flops(table, 96, 160, max_tap) == (
        jax_flops.conv_flops(table, 96, 160, max_tap)
    )
    taps = tuple(
        i for i in arch.get_architecture(model).default_style_layers
        if i <= max_tap
    )
    assert flops.gram_flops(table, 96, 160, taps) == (
        jax_flops.gram_flops(table, 96, 160, taps)
    )


def test_pools_before_in_equals_jax() -> None:
    table = arch.VGG19.layer_table
    for idx in range(len(table)):
        assert arch.pools_before_in(table, idx) == jax_arch.pools_before_in(
            table, idx,
        )


def test_vgg19_512_pinned() -> None:
    """The main path's count, as the JAX package's test pins it."""
    assert flops.step_flops(
        arch.VGG19.layer_table, 512, 512, (0, 5, 10, 19, 28), (21,),
    ) == 396_948_930_560


def test_audit_fields_against_the_h100_peak() -> None:
    v19 = arch.VGG19
    fields = flops.audit_fields(
        v19.layer_table, 512, 512, v19.default_style_layers,
        v19.default_content_layers, 100.0,
    )
    ref = jax_flops.audit_fields(
        v19.layer_table, 512, 512, v19.default_style_layers,
        v19.default_content_layers, 100.0,
    )
    for key in ("flops_per_step", "ms_per_step", "achieved_tflops"):
        assert fields[key] == ref[key]
    assert fields["mfu_pct"] == pytest.approx(
        100 * fields["achieved_tflops"] / 495.0, abs=0.05,
    )
    assert not any("v5e" in key for key in fields)
