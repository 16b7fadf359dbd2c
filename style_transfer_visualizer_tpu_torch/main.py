"""Entry points of the port: files in, stylized PNG out.

:func:`style_transfer` loads the two image files, runs the array-level
core :func:`run_style_transfer` and saves the final PNG (final-only:
no timelapse). The core loads the weights, computes the targets,
builds the L-BFGS step, initializes the image, runs the step loop and
returns the final image in [0, 1] with the loss history. Both run on
``config.hardware.device``, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationRunner,
)
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
    initialize_input,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)
from style_transfer_visualizer_tpu_torch.runtime.output import (
    save_final_image,
    setup_output_directory,
    stylized_image_path_from_paths,
)

if TYPE_CHECKING:
    import numpy as np
    import torch

    from style_transfer_visualizer_tpu_torch.config import (
        StyleTransferConfig,
    )
    from style_transfer_visualizer_tpu_torch.type_defs import (
        InputPaths,
        LossHistory,
    )


def run_style_transfer(
    content: np.ndarray,
    style: np.ndarray,
    config: StyleTransferConfig,
) -> tuple[torch.Tensor, LossHistory]:
    """Stylize ``content`` with ``style``; both (1, H, W, 3) in [0, 1].

    Returns the final (1, H, W, 3) image in [0, 1] on the run's device
    and the per-step loss history.
    """
    image, history, _ = _run(content, style, config)
    return image, history


def _run(
    content: np.ndarray,
    style: np.ndarray,
    config: StyleTransferConfig,
) -> tuple[torch.Tensor, LossHistory, float]:
    config.validate()
    opt = config.optimization
    device = setup_device(config.hardware.device)
    generator = setup_random_seed(opt.seed, device)
    content_img = image_io.host_array_to_device(
        content, device, normalize=opt.normalize,
    )
    style_img = image_io.host_array_to_device(
        style, device, normalize=opt.normalize,
    )
    params = load_pretrained_params(
        device, allow_random=opt.allow_random_weights, seed=opt.seed,
    )
    targets = compute_targets(
        params, style_img, content_img,
        tuple(opt.style_layers), tuple(opt.content_layers),
    )
    bundle = build_update_step(
        params,
        targets,
        tuple(content_img.shape),
        lr=opt.lr,
        style_w=opt.style_w,
        content_w=opt.content_w,
        style_layers=tuple(opt.style_layers),
        content_layers=tuple(opt.content_layers),
        lbfgs_max_iter=opt.lbfgs_max_iter,
        lbfgs_max_eval=opt.lbfgs_max_eval,
        lbfgs_history_size=opt.lbfgs_history_size,
        lbfgs_history_dtype=opt.lbfgs_history_dtype,
        lbfgs_direction=opt.lbfgs_direction,
    )
    input_img = initialize_input(content_img, opt.init_method, generator)
    image, history, elapsed = OptimizationRunner(
        bundle, input_img, config,
    ).run()
    final = image_io.prepare_image_for_output(image, normalize=opt.normalize)
    return final, history, elapsed


def style_transfer(
    paths: InputPaths,
    config: StyleTransferConfig,
) -> torch.Tensor:
    """Run the pipeline on two image files; return the final image.

    The final PNG goes to ``config.output.output`` under the canonical
    ``stylized_{content}_x_{style}.png`` name.
    """
    content = image_io.load_image_to_host_array(paths.content_path)
    style = image_io.load_image_to_host_array(paths.style_path)
    image, _, elapsed = _run(content, style, config)
    output_dir = setup_output_directory(config.output.output)
    final_path = stylized_image_path_from_paths(
        output_dir, Path(paths.content_path), Path(paths.style_path),
    )
    save_final_image(image, final_path, elapsed)
    return image
