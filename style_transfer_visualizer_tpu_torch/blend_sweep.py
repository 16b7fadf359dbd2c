"""Blend-sweep stylization: animate a morph between styles.

The port of the JAX package's ``blend_sweep.py``. Each output frame is
a converged stylization of the same content image at blend weights
interpolated along the style list (piecewise linear: style A -> B ->
C ...); frame i warm-starts from frame i-1's result, so adjacent frames
share an optimization trajectory and the animation stays coherent.

Each style's Gram targets are computed once; a frame's target is their
convex combination (``models.features.blend_targets``), handed to one
update step as an argument (``sequence.build_targets_update``). Frame 0
is pure style 0: its weights ``[1, 0, ...]`` give style 0's Grams
exactly, so frame 0 is the single run of style 0.

With ``hardware.spatial_shards = N > 1`` the frames' rows run over N
processes, as the sequence's do (``sequence.maybe_spatial_context``):
the Grams whole on every rank, the content features in rows once for
the sweep, rank 0 writing every file.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.engine.coarse import (
    coarse_init,
    resolve_coarse_steps,
)
from style_transfer_visualizer_tpu_torch.engine.step import (
    drive_chunked,
    refill,
)
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.models.features import (
    blend_targets,
    compute_targets,
    initialize_input,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)
from style_transfer_visualizer_tpu_torch.ops.color import maybe_restore_color
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.ops.precision import (
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)
from style_transfer_visualizer_tpu_torch.runtime.output import (
    setup_output_directory,
)
from style_transfer_visualizer_tpu_torch.runtime.validation import (
    validate_input_paths,
)
from style_transfer_visualizer_tpu_torch.main import check_spatial
from style_transfer_visualizer_tpu_torch.models.features import Targets
from style_transfer_visualizer_tpu_torch.parallel.mesh import Mesh, launch
from style_transfer_visualizer_tpu_torch.sequence import (
    _SEQUENCE_MAX_CHUNK,
    assemble_output_video,
    build_targets_update,
    maybe_spatial_context,
    spatial_frame_targets,
    spatial_start,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import StyleTransferConfig

_MIN_SWEEP_FRAMES = 2
_MIN_SWEEP_STYLES = 2


@dataclass(frozen=True)
class BlendSweepResult:
    """Outcome of a blend-sweep run.

    ``frame_seconds[i]`` is frame i's wall time, its PNG save included;
    ``frame_losses[i]`` is frame i's final total loss at its own blend
    weights.
    """

    frame_paths: list[Path]
    video_path: Path | None
    total_steps: int
    frame_seconds: tuple[float, ...] = ()
    frame_losses: tuple[float, ...] = ()


def sweep_weights(n_styles: int, n_frames: int) -> list[list[float]]:
    """Per-frame blend weights traversing the style list.

    Piecewise linear: frame 0 is pure style 0, the last frame pure
    style ``n_styles - 1``, and the sweep passes exactly through every
    style between. Every row is a convex combination (non-negative,
    summing to 1) with at most two non-zero entries.
    """
    if n_styles < _MIN_SWEEP_STYLES:
        msg = f"A blend sweep needs at least 2 styles, got {n_styles}"
        raise ValueError(msg)
    if n_frames < _MIN_SWEEP_FRAMES:
        msg = f"A blend sweep needs at least 2 frames, got {n_frames}"
        raise ValueError(msg)
    rows: list[list[float]] = []
    for i in range(n_frames):
        pos = i / (n_frames - 1) * (n_styles - 1)
        seg = min(int(pos), n_styles - 2)
        local = pos - seg
        row = [0.0] * n_styles
        row[seg] = 1.0 - local
        row[seg + 1] = local
        rows.append(row)
    return rows


def stylize_blend_sweep(
    content_path: str | Path,
    style_paths: list[str | Path],
    config: StyleTransferConfig,
    *,
    n_frames: int,
    sweep_steps: int | None = None,
    output_fps: float | None = None,
    mesh: Mesh | None = None,
) -> BlendSweepResult:
    """Render an ``n_frames`` morph of the content across the styles.

    Frame 0 gets the full ``optimization.steps`` (the sweep's only cold
    start, with the coarse warm start when it runs); later frames get
    ``sweep_steps`` each (by default the same: warm starts usually
    converge well below it, so a smaller value is the main throughput
    lever), each from a fresh optimizer state with the image carried
    over. Frames save as ``sweep_{i:04d}.png`` under the configured
    output directory and make
    ``blend_sweep_{content}_x_{s0+s1+...}.gif`` at ``output_fps``
    (default ``video.fps``).

    ``preserve_color="match"`` remaps every style onto the content's
    color statistics before the Grams are made; ``"luminance"``
    recolors every frame with the content's chrominance. Runs on
    ``config.hardware.device``. With ``spatial_shards > 1`` and no
    ``mesh`` it starts the ranks and returns rank 0's result; with a
    ``mesh`` it is that rank's part.
    """
    if len(style_paths) < _MIN_SWEEP_STYLES:
        msg = (
            "A blend sweep needs at least 2 --styles entries, got "
            f"{len(style_paths)}"
        )
        raise ValueError(msg)
    for style_path in style_paths:
        validate_input_paths(str(content_path), str(style_path))
    weights_rows = sweep_weights(len(style_paths), n_frames)
    per_frame_steps = (
        config.optimization.steps if sweep_steps is None else sweep_steps
    )
    if per_frame_steps < 1:
        msg = f"sweep_steps must be >= 1, got {per_frame_steps}"
        raise ValueError(msg)
    config.validate()
    if check_spatial(config, mesh) and mesh is None:
        return launch(
            stylize_blend_sweep, (content_path, style_paths, config),
            config.hardware.spatial_shards, config.hardware.device,
            kwargs={
                "n_frames": n_frames, "sweep_steps": sweep_steps,
                "output_fps": output_fps,
            },
        )
    device = (
        mesh.device if mesh is not None
        else setup_device(config.hardware.device)
    )
    generator = setup_random_seed(config.optimization.seed, device)
    return _sweep_on_device(
        Path(content_path), [Path(p) for p in style_paths], config,
        device, generator, weights_rows=weights_rows,
        per_frame_steps=per_frame_steps, output_fps=output_fps, mesh=mesh,
    )


def _sweep_on_device(
    content_path: Path,
    style_paths: list[Path],
    config: StyleTransferConfig,
    device: torch.device,
    generator: torch.Generator,
    *,
    weights_rows: list[list[float]],
    per_frame_steps: int,
    output_fps: float | None,
    mesh: Mesh | None,
) -> BlendSweepResult:
    opt = config.optimization
    writes = mesh is None or mesh.writes
    output_dir = setup_output_directory(config.output.output)
    content_host = image_io.load_image_to_host_array(content_path)
    content_img = image_io.host_array_to_device(
        content_host, device, normalize=opt.normalize,
    )
    match_to = content_host if opt.preserve_color == "match" else None
    chroma_source = (
        image_io.host_array_to_device(content_host, device)
        if opt.preserve_color == "luminance"
        else None
    )
    style_imgs = [
        image_io.load_style_image_to_array(
            p, device, normalize=opt.normalize, match_to=match_to,
        )
        for p in style_paths
    ]
    params = load_pretrained_params(
        device, arch=get_architecture(opt.model),
        allow_random=opt.allow_random_weights, seed=opt.seed,
    )
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)
    # One Targets per style, made once; the content features ride on
    # the first entry (blend_targets carries them through every mix).
    precision = resolve_precision(config.hardware.precision)
    spatial = maybe_spatial_context(
        config, params, tuple(content_img.shape), mesh,
    )
    per_style = [
        compute_targets(
            params, s_img, content_img, style_layers,
            content_layers if i == 0 and spatial is None else (), precision,
        )
        for i, s_img in enumerate(style_imgs)
    ]
    spatial_feats = None
    if spatial is not None:
        # The content is fixed across the sweep: its rows' features
        # (and Laplacian target) are made once for every mixture.
        spatial_feats = spatial_frame_targets(
            spatial, params, content_img, {}, config,
        ).content_feats
    _, update_many, init_state, run_params = build_targets_update(
        params,
        tuple(content_img.shape) if spatial is None else spatial.rows_shape,
        config,
        loss_fn=None if spatial is None else spatial.loss_fn,
        mesh=mesh,
    )

    opt.coarse_steps = resolve_coarse_steps(
        opt.coarse_steps, int(content_img.shape[1]),
        int(content_img.shape[2]), opt.steps,
    )

    def start() -> torch.Tensor:
        x = None
        if opt.coarse_steps > 0:
            # Frame 0 is pure style 0: the warm start serves the very
            # objective the sweep's first frame optimizes.
            x = coarse_init(
                params, content_img, style_imgs[0], config, generator,
            )
        if x is None:
            x = initialize_input(content_img, opt.init_method, generator)
        return x

    x = spatial_start(spatial, start)
    # The content is fixed across the sweep: one response serves every
    # mixture frame.
    lap_target = (
        lap_response(content_img, opt.lap_pool)
        if opt.lap_w and spatial is None else None
    )

    outputs: list[Path] = []
    frame_seconds: list[float] = []
    frame_losses: list[float] = []
    total_steps = 0
    held = state = None
    for i, weights in enumerate(weights_rows):
        frame_start = time.perf_counter()
        targets = blend_targets(per_style, weights)
        if spatial_feats is not None:
            targets = Targets(
                style_grams=targets.style_grams, content_feats=spatial_feats,
            )
        elif opt.lap_w:
            targets = (targets, lap_target)
        # The captured step reads its targets and state where they
        # are: each frame's mixture is copied into the targets held,
        # and the optimizer restarts in place.
        held = refill(held, targets)
        state = init_state(state)
        budget = opt.steps if i == 0 else per_frame_steps
        x, state, auxes = drive_chunked(
            lambda img, st, k: update_many(img, st, run_params, held, k),
            x, state, budget, min(budget, _SEQUENCE_MAX_CHUNK),
        )
        total_steps += budget
        out_path = output_dir / f"sweep_{i:04d}.png"
        whole = x if spatial is None else spatial.mesh.gather(x)
        if writes:
            image_io.save_array_as_image(
                maybe_restore_color(
                    image_io.prepare_image_for_output(
                        whole, normalize=opt.normalize,
                    ),
                    chroma_source,
                ),
                out_path,
            )
        outputs.append(out_path)
        frame_seconds.append(time.perf_counter() - frame_start)
        frame_losses.append(float(auxes.loss[-1]))
        logger.info(
            "Sweep frame %d/%d (weights %s, loss %.4g, %.2fs): %s",
            i + 1, len(weights_rows),
            "/".join(f"{w:.3f}" for w in weights),
            frame_losses[-1], frame_seconds[-1], out_path,
        )

    joined = "+".join(p.stem.replace(" ", "_") for p in style_paths)
    video_path = (
        output_dir
        / f"blend_sweep_{content_path.stem.replace(' ', '_')}_x_{joined}.gif"
    )
    if writes:
        assemble_output_video(
            outputs, video_path, output_fps or float(config.video.fps),
            config,
        )
    return BlendSweepResult(
        frame_paths=outputs,
        video_path=video_path,
        total_steps=total_steps,
        frame_seconds=tuple(frame_seconds),
        frame_losses=tuple(frame_losses),
    )
