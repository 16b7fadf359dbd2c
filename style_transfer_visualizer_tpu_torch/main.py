"""Entry points of the port: files in, stylized PNG and timelapse out.

The port of the JAX package's ``main.py`` for the single run, one
style or a weighted blend of several, with the whole objective (TV and
Laplacian terms, per-layer style weights, color preservation, L-BFGS
or Adam, VGG19 or VGG16) and the coarse-to-fine warm start:

- :func:`style_transfer` validates the inputs, applies the final-only
  cascade, loads the image files, picks the video mode, prepares
  the model and the starting image, and hands the step loop to
  :func:`run_with_artifacts`;
- :func:`run_with_artifacts` owns the artifact contract: the timelapse
  MP4 and GIF sinks with the intro and outro gallery segments, the loss
  CSV or in-memory history feeding the loss plot, and the final PNG,
  which is saved even when a sink fails to close (every sink is closed,
  the PNG is saved, then the first close error is raised);
- :func:`run_style_transfer` is the array-level core without media:
  arrays in, final image and loss history out;
- :func:`multi_style_transfer` is the multi-style batch: one content
  image against S styles, S independent stylizations in one stacked
  step (:func:`prepare_multi_style`, :func:`run_multi_style_loop`),
  one ``stylized_{content}_x_{style}.png`` and one timelapse per style.

All run on ``config.hardware.device``, CUDA unless the caller asks for
the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.engine.coarse import (
    coarse_init,
    multi_coarse_init,
    resolve_coarse_steps,
)
from style_transfer_visualizer_tpu_torch.engine.loss_logger import (
    LossCSVLogger,
)
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationRunner,
    SilentProgress,
    default_progress,
)
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.media import encode, segments
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream
from style_transfer_visualizer_tpu_torch.media.modes import select_video_mode
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
    initialize_input,
    targets_maybe_blended,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)
from style_transfer_visualizer_tpu_torch.ops.color import maybe_restore_color
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
    initialize_multi_inputs,
    multi_style_targets,
)
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)
from style_transfer_visualizer_tpu_torch.runtime.output import (
    save_outputs,
    setup_output_directory,
    stylized_image_path_from_names,
)
from style_transfer_visualizer_tpu_torch.runtime.validation import (
    validate_input_paths,
    validate_parameters,
)
from style_transfer_visualizer_tpu_torch.type_defs import SaveOptions
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu_torch.visualization.metrics import (
    plot_loss_curves,
)

if TYPE_CHECKING:
    from collections.abc import Callable

    from style_transfer_visualizer_tpu_torch.config import (
        StyleTransferConfig,
        VideoConfig,
    )
    from style_transfer_visualizer_tpu_torch.engine.runner import (
        ProgressReporter,
    )
    from style_transfer_visualizer_tpu_torch.engine.optimizers import (
        StepAux,
    )
    from style_transfer_visualizer_tpu_torch.engine.step import StepBundle
    from style_transfer_visualizer_tpu_torch.media.sinks import (
        VideoFrameSink,
    )
    from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
    from style_transfer_visualizer_tpu_torch.type_defs import (
        InputPaths,
        LossHistory,
    )


def prepare_model_and_input(
    content: np.ndarray,
    style: np.ndarray,
    config: StyleTransferConfig,
    *,
    params: Params | None = None,
    style_blend: list[tuple[np.ndarray, float]] | None = None,
) -> tuple[StepBundle, torch.Tensor]:
    """Weights, targets, the optimizer step and the starting image.

    ``content`` and ``style`` are (1, H, W, 3) host arrays in [0, 1].
    ``style_blend``, one ``(style array, weight)`` per style, blends
    the styles' Gram targets (``models.features.blend_targets``); the
    weights are used as given. With ``preserve_color="match"`` every
    style is color-matched to the content on the host first. The
    coarse warm start's auto mode is resolved here, against the
    content's size, and written back to ``config``. ``params`` reuses
    weights already on the run's device; by default they are loaded
    (or made from the seed) for ``config.optimization.model``.
    """
    config.validate()
    opt = config.optimization
    device = setup_device(config.hardware.device)
    generator = setup_random_seed(opt.seed, device)
    content_img = image_io.host_array_to_device(
        content, device, normalize=opt.normalize,
    )
    match_to = content if opt.preserve_color == "match" else None

    def style_on_device(host: np.ndarray) -> torch.Tensor:
        return image_io.style_array_to_device(
            host, device, normalize=opt.normalize, match_to=match_to,
        )

    style_img = style_on_device(style)
    blend_imgs = None
    if style_blend:
        blend_imgs = [
            (style_on_device(host), float(weight))
            for host, weight in style_blend
        ]
    _resolve_auto_coarse(config, content_img)
    if params is None:
        params = load_pretrained_params(
            device, arch=get_architecture(opt.model),
            allow_random=opt.allow_random_weights, seed=opt.seed,
        )
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)

    def one_targets(s_img: torch.Tensor, layers: tuple[int, ...]):
        return compute_targets(
            params, s_img, content_img, style_layers, layers,
        )

    targets = targets_maybe_blended(
        one_targets, style_img, content_layers, blend_imgs,
    )
    lap_target = (
        lap_response(content_img, opt.lap_pool) if opt.lap_w else None
    )
    bundle = build_update_step(
        params,
        targets,
        tuple(content_img.shape),
        optimizer=opt.optimizer,
        lr=opt.lr,
        style_w=opt.style_w,
        content_w=opt.content_w,
        tv_w=opt.tv_w,
        lap_w=opt.lap_w,
        lap_pool=opt.lap_pool,
        lap_target=lap_target,
        style_layers=style_layers,
        content_layers=content_layers,
        style_weights=opt.style_weights_tuple(),
        lbfgs_max_iter=opt.lbfgs_max_iter,
        lbfgs_max_eval=opt.lbfgs_max_eval,
        lbfgs_history_size=opt.lbfgs_history_size,
        lbfgs_history_dtype=opt.lbfgs_history_dtype,
        lbfgs_direction=opt.lbfgs_direction,
    )
    input_img = _initial_image(
        params, content_img, style_img, config, generator,
        blend_imgs=blend_imgs,
    )
    return bundle, input_img


def _resolve_auto_coarse(
    config: StyleTransferConfig,
    content_img: torch.Tensor,
) -> None:
    """Resolve ``coarse_steps=-1`` (auto) against the content size.

    The resolved value is written back, so every later
    ``coarse_steps > 0`` gate keeps its meaning.
    """
    opt = config.optimization
    opt.coarse_steps = resolve_coarse_steps(
        opt.coarse_steps,
        int(content_img.shape[1]),
        int(content_img.shape[2]),
        opt.steps,
    )


def _initial_image(
    params: Params,
    content_img: torch.Tensor,
    style_img: torch.Tensor,
    config: StyleTransferConfig,
    generator: torch.Generator,
    *,
    blend_imgs: list[tuple[torch.Tensor, float]] | None,
) -> torch.Tensor:
    """The coarse warm start when it runs, else ``init_method``."""
    if config.optimization.coarse_steps > 0:
        warm = coarse_init(
            params, content_img, style_img, config, generator,
            blend_imgs=blend_imgs,
        )
        if warm is not None:
            return warm
    return initialize_input(
        content_img, config.optimization.init_method, generator,
    )


def _chroma_source(
    content: np.ndarray,
    config: StyleTransferConfig,
    device: torch.device,
) -> torch.Tensor | None:
    """The raw content image on ``device`` for ``preserve_color="luminance"``.

    Not normalized: luminance transfer works on [0,1] RGB.
    """
    if config.optimization.preserve_color != "luminance":
        return None
    return image_io.host_array_to_device(content, device)


def run_style_transfer(
    content: np.ndarray,
    style: np.ndarray,
    config: StyleTransferConfig,
    *,
    style_blend: list[tuple[np.ndarray, float]] | None = None,
) -> tuple[torch.Tensor, LossHistory]:
    """Stylize ``content`` with ``style``; both (1, H, W, 3) in [0, 1].

    ``style_blend`` as in :func:`prepare_model_and_input`. Returns the
    final (1, H, W, 3) image in [0, 1] on the run's device, recolored
    with the content's chrominance under ``preserve_color="luminance"``,
    and the loss history (``{}`` when a loss CSV owns the series). No
    media and no progress bar: frames, plot and PNG belong to
    :func:`style_transfer`.
    """
    bundle, input_img = prepare_model_and_input(
        content, style, config, style_blend=style_blend,
    )
    image, history, _ = OptimizationRunner(
        bundle.update_fn, bundle.opt_state, input_img, config,
        progress_bar=SilentProgress(),
        chunked_update_fn=bundle.chunked_update_fn,
    ).run()
    final = maybe_restore_color(
        image_io.prepare_image_for_output(
            image, normalize=config.optimization.normalize,
        ),
        _chroma_source(content, config, image.device),
    )
    return final, history


def style_transfer(
    paths: InputPaths,
    config: StyleTransferConfig,
    *,
    style_blend: list[tuple[str, float]] | None = None,
    progress_bar: ProgressReporter | None = None,
) -> torch.Tensor:
    """Run the full pipeline on image files; return the final image.

    The final image is (1, H, W, 3) in [0, 1] on the run's device. The
    final PNG, the timelapse MP4/GIF, the loss CSV or plot go to
    ``config.output.output`` under the JAX package's names.
    ``style_blend``, one ``(style path, weight)`` per style, makes one
    stylization from the styles' blended Gram targets, named with the
    joined style stems; ``paths.style_path`` then only fronts the intro
    and outro panels.
    """
    validate_input_paths(paths.content_path, paths.style_path)
    for blend_path, _ in style_blend or ():
        validate_input_paths(paths.content_path, blend_path)
    validate_parameters(config.video.quality)

    # Final-only mode disables all timelapse outputs.
    if config.video.final_only:
        config.video.create_video = False
        config.video.create_gif = False
        config.video.save_every = config.optimization.steps + 1

    content = image_io.load_image_to_host_array(paths.content_path)
    style = image_io.load_image_to_host_array(paths.style_path)
    blend_arrays = None
    if style_blend:
        blend_arrays = [
            (image_io.load_image_to_host_array(path), weight)
            for path, weight in style_blend
        ]

    if config.video.create_video:
        height, width = content.shape[1:3]
        effective_mode, reason, frame_estimate = select_video_mode(
            config.video,
            frame_size=(int(width), int(height)),
            total_steps=config.optimization.steps,
        )
        config.video.mode = effective_mode
        if reason is not None:
            logger.info(
                "Auto-selected postprocess video mode (%s). "
                "Estimated frames: %d.",
                reason, frame_estimate,
            )

    bundle, input_img = prepare_model_and_input(
        content, style, config, style_blend=blend_arrays,
    )
    style_name = None
    if style_blend:
        # Blended outputs name every contributing style, in user order.
        style_name = "+".join(Path(path).stem for path, _ in style_blend)
    result = run_with_artifacts(
        bundle.update_fn,
        bundle.chunked_update_fn,
        bundle.opt_state,
        input_img,
        config,
        content_path=Path(paths.content_path),
        style_path=Path(paths.style_path),
        style_name=style_name,
        chroma_source=_chroma_source(content, config, input_img.device),
        progress_bar=progress_bar,
    )
    return result.image


@dataclass(slots=True)
class ArtifactRunResult:
    """What the artifact-contract loop hands back to its caller."""

    #: Prepared final image in [0, 1].
    image: torch.Tensor
    #: Path of the saved final PNG.
    final_path: Path
    #: Exported loss history (empty when CSV logging owned the series).
    loss_history: LossHistory
    #: Optimization wall-clock seconds.
    elapsed: float
    #: Last host-synced total loss (NaN when no row ever synced).
    final_total_loss: float


def run_with_artifacts(
    update_fn,
    chunked_update_fn,
    opt_state,
    input_img: torch.Tensor,
    config: StyleTransferConfig,
    *,
    content_path: Path,
    style_path: Path,
    style_name: str | None = None,
    chroma_source: torch.Tensor | None = None,
    progress_bar: ProgressReporter | None = None,
) -> ArtifactRunResult:
    """Drive a prepared update loop with the full artifact contract.

    Timelapse MP4/GIF sinks with intro/outro gallery segments, the loss
    CSV or in-memory history feeding the loss plot, artifact survival on
    sink failure, and the final PNG. The input stems name the
    artifacts (``stylized_{content}_x_{style}.png``,
    ``timelapse_{content}_x_{style}.mp4``); ``style_name`` overrides
    the style stem (a blend joins its stems). ``content_path`` and
    ``style_path`` also feed the intro/outro gallery panels.
    ``chroma_source`` (the raw content image on the run's device)
    recolors every frame, the outro, the PNG and the returned image
    with the content's chrominance.
    """
    opt_cfg = config.optimization
    output_path = setup_output_directory(config.output.output)
    content_name = content_path.stem
    if style_name is None:
        style_name = style_path.stem
    video_name = f"timelapse_{content_name}_x_{style_name}.mp4"
    gif_name = f"timelapse_{content_name}_x_{style_name}.gif"

    video_writer = encode.setup_video_writer(
        config.video, output_path, video_name,
    )
    gif_collector = encode.setup_gif_collector(
        config.video, output_path, gif_name,
    )
    gif_segment_options = segments.GifSegmentOptions(
        sink=gif_collector,
        include_intro=config.video.gif_include_intro,
        include_outro=config.video.gif_include_outro,
    )

    intro_last_frame = None
    intro_crossfade_frames = 0
    gif_intro_requested = (
        gif_collector is not None and config.video.gif_include_intro
    )
    if video_writer is not None or gif_intro_requested:
        intro_info = segments.prepare_intro_segment(
            config.video,
            video_writer,
            (content_path, style_path),
            gif_options=gif_segment_options,
        )
        if intro_info is not None:
            intro_last_frame, intro_crossfade_frames = intro_info

    runner = OptimizationRunner(
        update_fn,
        opt_state,
        input_img,
        config,
        progress_bar=progress_bar,
        video_writer=video_writer,
        gif_collector=gif_collector,
        intro_last_frame=intro_last_frame,
        intro_crossfade_frames=intro_crossfade_frames,
        chunked_update_fn=chunked_update_fn,
        chroma_source=chroma_source,
    )
    # The optimized image must survive late media failures: every sink
    # is closed even when one fails, and the final PNG is saved before
    # any close error is re-raised. Close errors are kept per sink so a
    # failed GIF encode does not mislabel a fine MP4 (or vice versa).
    close_errors: dict[str, Exception] = {}
    try:
        input_img, loss_metrics, elapsed = runner.run()
        _maybe_append_final_segments(
            config.video,
            video_writer,
            gif_segment_options,
            content_path,
            style_path,
            input_img,
            normalize=opt_cfg.normalize,
            chroma_source=chroma_source,
        )
    finally:
        for sink_name, sink in (
            ("video", video_writer),
            ("gif", gif_collector),
        ):
            if not sink:
                continue
            try:
                sink.close()
            except Exception as exc:  # noqa: BLE001
                logger.error(
                    "Error closing %s media sink: %s", sink_name, exc,
                )
                close_errors[sink_name] = exc

    save_opts = SaveOptions(
        content_name=content_name,
        style_name=style_name,
        video_name=video_name if video_writer else None,
        gif_name=gif_name if gif_collector else None,
        normalize=opt_cfg.normalize,
        video_created=video_writer is not None
        and "video" not in close_errors,
        gif_created=gif_collector is not None and "gif" not in close_errors,
        plot_losses=config.output.plot_losses,
        chroma_source=chroma_source,
    )
    save_outputs(input_img, loss_metrics, output_path, elapsed, save_opts)
    if close_errors:
        raise next(iter(close_errors.values()))

    if loss_metrics.get("total_loss"):
        final_total = float(loss_metrics["total_loss"][-1])
    elif runner.latest_logged is not None:
        final_total = runner.latest_logged.total_loss
    else:
        final_total = float("nan")
    final_path = stylized_image_path_from_names(
        output_path, content_name, style_name,
    )
    return ArtifactRunResult(
        image=maybe_restore_color(
            image_io.prepare_image_for_output(
                input_img, normalize=opt_cfg.normalize,
            ),
            chroma_source,
        ),
        final_path=final_path,
        loss_history=loss_metrics,
        elapsed=elapsed,
        final_total_loss=final_total,
    )


def _maybe_append_final_segments(
    video_config: VideoConfig,
    video_writer: VideoFrameSink | None,
    gif_options: segments.GifSegmentOptions | None,
    content_path: Path,
    style_path: Path,
    input_img: torch.Tensor,
    *,
    normalize: bool,
    chroma_source: torch.Tensor | None = None,
) -> None:
    """Append outro comparison frames to active sinks when configured."""
    gif_outro_requested = bool(
        gif_options and gif_options.sink and gif_options.include_outro,
    )
    if not video_config.final_frame_compare:
        return
    if video_writer is None and not gif_outro_requested:
        return

    final_frame = np.ascontiguousarray(
        image_io.array_to_uint8_frame(
            input_img, normalize=normalize, chroma_source=chroma_source,
        ),
    )
    kwargs = {}
    if gif_options is not None and gif_options.sink is not None:
        kwargs["gif_options"] = gif_options
    segments.append_final_comparison_frame(
        video_config,
        video_writer,
        (content_path, style_path),
        final_frame,
        **kwargs,
    )


# ---- the multi-style batch


def prepare_multi_style(
    content: np.ndarray,
    styles: list[np.ndarray],
    config: StyleTransferConfig,
    *,
    params: Params | None = None,
) -> tuple[StepBundle, torch.Tensor]:
    """Weights, stacked targets, the stacked step and starting images.

    ``content`` and each of ``styles`` are (1, H, W, 3) host arrays in
    [0, 1]; the styles may differ in size. The color contract is the
    single run's: ``preserve_color="match"`` recolors every style to
    the content first. The auto warm start is resolved against the
    content, as in :func:`prepare_model_and_input`. Returns the bundle
    and the ``(S, 1, H, W, 3)`` starting images.
    """
    config.validate()
    opt = config.optimization
    device = setup_device(config.hardware.device)
    generator = setup_random_seed(opt.seed, device)
    content_img = image_io.host_array_to_device(
        content, device, normalize=opt.normalize,
    )
    match_to = content if opt.preserve_color == "match" else None
    style_imgs = [
        image_io.style_array_to_device(
            host, device, normalize=opt.normalize, match_to=match_to,
        )
        for host in styles
    ]
    _resolve_auto_coarse(config, content_img)
    if params is None:
        params = load_pretrained_params(
            device, arch=get_architecture(opt.model),
            allow_random=opt.allow_random_weights, seed=opt.seed,
        )
    n_styles = len(style_imgs)
    targets = multi_style_targets(
        params, content_img, style_imgs,
        tuple(opt.style_layers), tuple(opt.content_layers),
    )
    bundle = build_multi_style_update(
        params, targets, tuple(content_img.shape), n_styles,
        optimizer=opt.optimizer,
        lr=opt.lr,
        style_w=opt.style_w,
        content_w=opt.content_w,
        tv_w=opt.tv_w,
        lap_w=opt.lap_w,
        lap_pool=opt.lap_pool,
        # One content image serves every style.
        lap_target=(
            lap_response(content_img, opt.lap_pool) if opt.lap_w else None
        ),
        style_layers=tuple(opt.style_layers),
        style_weights=opt.style_weights_tuple(),
        content_layers=tuple(opt.content_layers),
        lbfgs_max_iter=opt.lbfgs_max_iter,
        lbfgs_max_eval=opt.lbfgs_max_eval,
        lbfgs_history_size=opt.lbfgs_history_size,
        lbfgs_history_dtype=opt.lbfgs_history_dtype,
        lbfgs_direction=opt.lbfgs_direction,
    )
    images = _multi_initial_images(
        params, content_img, style_imgs, config, generator,
    )
    return bundle, images


def _multi_initial_images(
    params: Params,
    content_img: torch.Tensor,
    style_imgs: list[torch.Tensor],
    config: StyleTransferConfig,
    generator: torch.Generator,
) -> torch.Tensor:
    """The batched warm start when it runs, else ``init_method``."""
    if config.optimization.coarse_steps > 0:
        warm = multi_coarse_init(
            params, content_img, style_imgs, config, generator,
        )
        if warm is not None:
            return warm
    return initialize_multi_inputs(
        content_img, config.optimization.init_method, generator,
        len(style_imgs),
    )


def multi_style_transfer(
    content_path: str,
    style_paths: list[str],
    config: StyleTransferConfig,
    *,
    progress_bar: ProgressReporter | None = None,
) -> list[Path]:
    """Stylize one content image with each of S styles, in one batch.

    The S problems are independent and run as one stacked step on
    ``config.hardware.device``. Outputs are
    ``stylized_{content}_x_{style}.png`` per style; ``--gif`` makes one
    timelapse GIF per style and video one postprocess MP4 per style
    (realtime is promoted to postprocess). Returns the PNG paths.
    """
    if not style_paths:
        msg = "multi_style_transfer requires at least one style path"
        raise ValueError(msg)
    # The single run's final-only cascade.
    if config.video.final_only:
        config.video.create_video = False
        config.video.create_gif = False
    for style_path in style_paths:
        validate_input_paths(content_path, style_path)

    content = image_io.load_image_to_host_array(content_path)
    styles = [image_io.load_image_to_host_array(p) for p in style_paths]
    bundle, images = prepare_multi_style(content, styles, config)
    logger.info(
        "Multi-style run: %d styles in one stacked step.", len(styles),
    )
    output_path = setup_output_directory(config.output.output)
    chroma_source = _chroma_source(content, config, images.device)
    style_names = [Path(p).stem for p in style_paths]
    content_name = Path(content_path).stem
    images, _, close_errors = run_multi_style_loop(
        bundle, images, config, output_path, style_names,
        content_name=content_name,
        content_path=Path(content_path),
        style_paths=[Path(p) for p in style_paths],
        chroma_source=chroma_source,
        progress_bar=progress_bar,
    )
    saved = _save_multi_style_outputs(
        images, style_names, content_name, output_path,
        normalize=config.optimization.normalize,
        chroma_source=chroma_source,
    )
    if close_errors:
        raise close_errors[0]
    return saved


def _prepared_frames(
    images: torch.Tensor,
    *,
    normalize: bool,
    chroma_source: torch.Tensor | None,
) -> torch.Tensor:
    """(S, H, W, 3) uint8 frames of the stacked images, on the device."""
    return image_io.pack_uint8_frames_batch(
        maybe_restore_color(
            image_io.prepare_image_for_output(images, normalize=normalize),
            chroma_source,
        ),
    )


def _default_sink(
    config: StyleTransferConfig, output_path: Path, kind: str, name: str,
) -> VideoFrameSink:
    """The real encoder for a batch timelapse: ``kind`` gif or mp4."""
    if kind == "gif":
        return encode.GifFrameCollector(
            (output_path / name).resolve(), config.video.fps,
        )
    return encode.setup_video_writer(config.video, output_path, name)


class _BatchFrames:
    """Per-style sinks of a batch timelapse, fed one stacked frame.

    Each style's intro fade and hold go to its sinks when they are
    made; the crossfade into a style's first stylized frame is appended
    on the frame worker before that frame (the worker is FIFO, so it
    lands once, in order). :meth:`deliver` fans one ``(S, H, W, 3)``
    array out to every style's sinks.
    """

    def __init__(
        self,
        config: StyleTransferConfig,
        output_path: Path,
        content_name: str,
        style_names: list[str],
        make_sink: Callable[[str, str], VideoFrameSink],
        intro_paths: list[tuple[Path, Path]] | None,
    ) -> None:
        """Make the sinks and emit each style's intro."""
        video = config.video
        self.config = config
        n = len(style_names)
        self.gif: list[VideoFrameSink | None] = [None] * n
        self.video: list[VideoFrameSink | None] = [None] * n
        #: (label, sink) per style, so close errors name the sink.
        self.labelled: list[list[tuple[str, VideoFrameSink]]] = [
            [] for _ in style_names
        ]
        self.media_names: list[str] = []
        for kind, wanted, into in (
            ("gif", video.create_gif, self.gif),
            ("mp4", video.create_video, self.video),
        ):
            if not (wanted and video.save_every):
                continue
            for i, style in enumerate(style_names):
                label = f"timelapse_{content_name}_x_{style}.{kind}"
                into[i] = make_sink(kind, label)
                self.labelled[i].append((label, into[i]))
                self.media_names.append(label)
        self.pending: list[tuple[np.ndarray, int] | None] = [None] * n
        if intro_paths is None:
            return
        for i in range(n):
            if self.video[i] is None and self.gif[i] is None:
                continue
            gif_options = None
            if self.gif[i] is not None:
                gif_options = segments.GifSegmentOptions(
                    sink=self.gif[i], include_intro=video.gif_include_intro,
                )
            self.pending[i] = segments.prepare_intro_segment(
                video, self.video[i], intro_paths[i],
                gif_options=gif_options,
            )

    @property
    def active(self) -> bool:
        """Whether any style has a sink."""
        return any(self.labelled)

    def deliver(self, frames: np.ndarray) -> None:
        """Hand frame s of ``frames`` to style s's sinks (worker thread)."""
        video = self.config.video
        for i, (sinks, frame) in enumerate(
            zip(self.labelled, frames, strict=True),
        ):
            intro = self.pending[i]
            if intro is not None:
                intro_last, n_crossfade = intro
                # A pending intro implies intro_enabled (the intro
                # returns None without it).
                if self.video[i] is not None:
                    segments.append_crossfade(
                        self.video[i], intro_last, frame, n_crossfade,
                    )
                if self.gif[i] is not None and video.gif_include_intro:
                    segments.append_crossfade(
                        self.gif[i], intro_last, frame, n_crossfade,
                    )
                self.pending[i] = None
            for _, sink in sinks:
                sink.append_data(frame)

    def append_outros(
        self,
        frames: np.ndarray,
        outro_paths: list[tuple[Path, Path]] | None,
    ) -> None:
        """Each style's hold, crossfade and outro comparison.

        The single run's outro per style, under ``final_frame_compare``
        and, for GIFs, ``gif_include_outro``; ``frames`` are the final
        images packed, ``(S, H, W, 3)``.
        """
        video = self.config.video
        if not video.final_frame_compare or outro_paths is None:
            return
        for i, paths in enumerate(outro_paths):
            wants_gif = self.gif[i] is not None and video.gif_include_outro
            if self.video[i] is None and not wants_gif:
                continue
            gif_options = None
            if self.gif[i] is not None:
                gif_options = segments.GifSegmentOptions(
                    sink=self.gif[i], include_intro=False,
                    include_outro=video.gif_include_outro,
                )
            segments.append_final_comparison_frame(
                video, self.video[i], paths,
                np.ascontiguousarray(frames[i]), gif_options=gif_options,
            )

    def close(self) -> tuple[list[Exception], set[str]]:
        """Close every sink; the errors and the labels that failed."""
        errors: list[Exception] = []
        failed: set[str] = set()
        for sinks in self.labelled:
            for label, sink in sinks:
                try:
                    sink.close()
                except Exception as exc:  # noqa: BLE001
                    logger.error(
                        "Error closing media sink %s: %s", label, exc,
                    )
                    errors.append(exc)
                    failed.add(label)
        return errors, failed


def run_multi_style_loop(
    bundle: StepBundle,
    images: torch.Tensor,
    config: StyleTransferConfig,
    output_path: Path,
    style_names: list[str],
    *,
    content_name: str = "content",
    content_path: Path | None = None,
    style_paths: list[Path] | None = None,
    chroma_source: torch.Tensor | None = None,
    progress_bar: ProgressReporter | None = None,
    make_sink: Callable[[str, str], VideoFrameSink] | None = None,
    on_step_end: Callable[[int, torch.Tensor, StepAux], None] | None = None,
):
    """The batch's step loop with its logging and timelapse contract.

    The port of the JAX package's ``main._run_multi_style_loop``
    without checkpoints and with single-step dispatch:

    - per-style loss CSVs ``<log_loss stem>_<style><suffix or .csv>``,
      or per-style histories for ``loss_plot_<style>.png``; one ``(3,
      S)`` host read per ``log_every`` and none between;
    - one timelapse per style (``timelapse_{content}_x_{style}.gif`` /
      ``.mp4``; a realtime MP4 is promoted to postprocess), fed at the
      ``save_every`` cadence and after the last step when ``steps``
      is not a multiple of it: the S frames are packed on the device
      together and go through ``frame_stream`` in one submit, and the
      worker fans them out to each style's sinks, intro crossfades
      first (``content_path`` and ``style_paths`` give the intro and
      outro panels; without them there are none);
    - the stream is drained before the outros; every sink is closed
      even when one fails.

    ``make_sink(kind, file_name)``, ``kind`` ``"gif"`` or ``"mp4"``,
    stands in for the encoders; ``on_step_end(step, images, aux)`` sees
    each step's images and device metrics (no host read). Returns
    ``(images, state, close_errors)``: the caller saves the PNGs before
    it raises the first close error.
    """
    opt_cfg = config.optimization
    out_cfg = config.output
    video = config.video
    if video.create_video and video.mode != "postprocess":
        # S concurrent streaming encoders would contend on the host;
        # spilled frames encode serially on close instead.
        logger.info(
            "Batch (multi-style) mode encodes MP4 in postprocess mode; "
            "promoting from '%s'.", video.mode,
        )
        video.mode = "postprocess"
    if make_sink is None:
        def make_sink(kind: str, name: str) -> VideoFrameSink:
            return _default_sink(config, output_path, kind, name)

    intro_paths = None
    if content_path is not None and style_paths is not None:
        intro_paths = [(content_path, s) for s in style_paths]
    media = _BatchFrames(
        config, output_path, content_name, style_names, make_sink,
        intro_paths,
    )
    frame_stream = None
    if media.active:
        logger.info(
            "Batch mode writes one timelapse per style, with the same "
            "intro/outro segments as a single run where enabled.",
        )
        frame_stream = AsyncFrameStream()

    def submit_frames(imgs: torch.Tensor) -> None:
        frame_stream.submit(
            _prepared_frames(
                imgs, normalize=opt_cfg.normalize,
                chroma_source=chroma_source,
            ),
            media.deliver,
        )

    csv_loggers: list[LossCSVLogger | None] = [None] * len(style_names)
    if out_cfg.log_loss:
        base = Path(out_cfg.log_loss)
        for i, name in enumerate(style_names):
            per_style = base.with_name(
                f"{base.stem}_{name}{base.suffix or '.csv'}",
            )
            try:
                csv_loggers[i] = LossCSVLogger(per_style, out_cfg.log_every)
            except OSError as exc:
                logger.error(
                    "Failed to initialize CSV logging for style %s: %s",
                    name, exc,
                )
        logger.info(
            "Per-style loss CSV logging enabled under %s.", base.parent,
        )
    track_history = out_cfg.plot_losses and not out_cfg.log_loss
    histories: list[LossHistory] = [
        {"style_loss": [], "content_loss": [], "total_loss": []}
        for _ in style_names
    ]
    save_every = video.save_every
    bar = progress_bar or default_progress(
        opt_cfg.steps, 0, desc="Multi-Style Transfer",
    )

    def log_step(step: int, aux: StepAux) -> None:
        # One (3, S) host read: style, content, total.
        vals = torch.stack(
            [aux.style_score, aux.content_score, aux.loss],
        ).cpu().numpy()
        for i in range(len(style_names)):
            row = [float(v) for v in vals[:, i]]
            if csv_loggers[i] is not None:
                csv_loggers[i].log(step, *row)
            if track_history:
                for key, v in zip(
                    ("style_loss", "content_loss", "total_loss"), row,
                    strict=True,
                ):
                    histories[i][key].append(v)
        bar.set_postfix({"mean_loss": f"{vals[2].mean():.4f}"})

    state = bundle.opt_state
    close_errors: list[Exception] = []
    failed: set[str] = set()
    try:
        for step in range(1, opt_cfg.steps + 1):
            images, state, aux = bundle.update_fn(images, state)
            bar.update(1)
            if on_step_end is not None:
                on_step_end(step, images, aux)
            if frame_stream is not None and step % save_every == 0:
                submit_frames(images)
            if step % out_cfg.log_every == 0:
                log_step(step, aux)
        if frame_stream is not None:
            if opt_cfg.steps % save_every:
                # Every timelapse ends on the finished image.
                submit_frames(images)
            # FIFO: every frame lands before the outros are appended.
            frame_stream.drain()
            media.append_outros(
                _prepared_frames(
                    images, normalize=opt_cfg.normalize,
                    chroma_source=chroma_source,
                ).cpu().numpy(),
                intro_paths,
            )
    finally:
        bar.close()
        if frame_stream is not None:
            try:
                frame_stream.close()
            except Exception as exc:  # noqa: BLE001
                logger.error("Error closing frame stream: %s", exc)
                close_errors.append(exc)
        sink_errors, failed = media.close()
        close_errors.extend(sink_errors)
        for csv_logger in csv_loggers:
            if csv_logger is not None:
                try:
                    csv_logger.close()
                except OSError as exc:
                    logger.error("Error closing loss logger: %s", exc)

    if track_history:
        for name, history in zip(style_names, histories, strict=True):
            if history["total_loss"]:
                plot_loss_curves(
                    history, output_path, filename=f"loss_plot_{name}.png",
                )
    for media_name in media.media_names:
        if media_name not in failed:
            logger.info(
                "Timelapse saved to: %s", output_path / media_name,
            )
    return images, state, close_errors


def _save_multi_style_outputs(
    images: torch.Tensor,
    style_names: list[str],
    content_name: str,
    output_path: Path,
    *,
    normalize: bool,
    chroma_source: torch.Tensor | None = None,
) -> list[Path]:
    """One ``stylized_{content}_x_{style}.png`` per style, recolored
    against the content under ``preserve_color="luminance"``."""
    saved: list[Path] = []
    for i, style_name in enumerate(style_names):
        final = maybe_restore_color(
            image_io.prepare_image_for_output(
                images[i], normalize=normalize,
            ),
            chroma_source,
        )
        out_file = stylized_image_path_from_names(
            output_path, content_name, style_name,
        )
        image_io.save_array_as_image(final, out_file)
        logger.info("Stylized image saved to: %s", out_file)
        saved.append(out_file)
    return saved
