"""The port runs on the CPU only when asked to by name.

CUDA is made absent with monkeypatch, so these hold on any machine.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch import cli
from style_transfer_visualizer_tpu_torch.config import (
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.main import run_style_transfer
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_setup_device_cuda_raises_without_a_card(no_cuda) -> None:
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_device("cuda")


def test_setup_device_cpu_by_name() -> None:
    assert setup_device("cpu") == torch.device("cpu")


def test_setup_device_rejects_other_devices() -> None:
    with pytest.raises(ValueError, match="Unknown device"):
        setup_device("mps")


def test_entry_point_defaults_to_cuda_and_raises(no_cuda) -> None:
    assert StyleTransferConfig().hardware.device == "cuda"
    img = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_style_transfer(img, img, StyleTransferConfig())


def test_cli_defaults_to_cuda_and_raises(
    no_cuda, content_image, style_image, tmp_path,
) -> None:
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([
            "--content", str(content_image), "--style", str(style_image),
            "--output", str(tmp_path / "out"), "--steps", "1",
        ])


def test_cli_flags_reach_the_config() -> None:
    args = cli.build_parser().parse_args([
        "--content", "c.png", "--style", "s.png", "--device", "cpu",
        "--steps", "7", "--style-layers", "0,5", "--no-normalize",
        "--lbfgs-history-dtype", "float32", "--allow-random-weights",
    ])
    config = cli.config_from_args(args)
    assert config.hardware.device == "cpu"
    assert config.optimization.steps == 7
    assert config.optimization.style_layers == [0, 5]
    assert config.optimization.normalize is False
    assert config.optimization.lbfgs_history_dtype == "float32"
    assert config.optimization.allow_random_weights is True


def test_cli_rejects_out_of_range_values(capsys) -> None:
    with pytest.raises(SystemExit):
        cli.main(["--content", "c.png", "--style", "s.png", "--steps", "0"])
    assert "steps must be >= 1" in capsys.readouterr().err


def test_seeded_generator_repeats() -> None:
    a = torch.randn(4, generator=setup_random_seed(5, torch.device("cpu")))
    b = torch.randn(4, generator=setup_random_seed(5, torch.device("cpu")))
    assert torch.equal(a, b)


@pytest.mark.parametrize(
    ("section", "kwargs"),
    [
        (OptimizationConfig, {"steps": 0}),
        (OptimizationConfig, {"lr": 0.0}),
        (OptimizationConfig, {"lbfgs_history_size": 0}),
        (OptimizationConfig, {"lbfgs_direction": "newton"}),
        (OptimizationConfig, {"init_method": "noise"}),
        (OutputConfig, {"log_every": 0}),
    ],
)
def test_config_bounds(section, kwargs) -> None:
    with pytest.raises(ValueError, match="must"):
        section(**kwargs)


def test_config_validate_checks_later_assignment() -> None:
    config = StyleTransferConfig()
    config.optimization.steps = -1
    with pytest.raises(ValueError, match="steps"):
        config.validate()
