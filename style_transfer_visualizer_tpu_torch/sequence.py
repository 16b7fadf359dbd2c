"""Frame-sequence stylization: stylize a video clip frame by frame.

The port of the JAX package's ``sequence.py``. Each input frame is
optimized against the clip's one style target with its own content
target; frames after the first warm-start from the previous frame's
stylized result, which converges faster and keeps the output temporally
coherent (``BASELINE.json`` configs[4]).

:func:`build_targets_update` is the update step whose targets are an
argument of every call, not a closure: one step serves every frame of
the clip (its content targets), every mixture of the blend sweep
(``blend_sweep.py``) and the regional run's masked targets
(``regional.py``). It is ``engine.step.targets_update`` over the same
objective that ``engine.step.build_update_step`` binds, so a frame's
steps are the single run's, bit for bit.

Host work is pipelined around the device work: while frame k
optimizes, a worker thread decodes frame k+1, and frame k-1's PNG is
encoded by the worker of ``media.stream.AsyncFrameStream``. On the
card the stylized frame is packed to uint8 on the device and copied
``non_blocking`` into a page-locked buffer on the issuing thread, with
an event recorded after it; the worker waits on that event, so the
copy is ordered right after the frame's own steps and the next
frame's kernels queue behind it. The one host read per frame is its
final loss.

``hardware.spatial_shards = N > 1`` splits every frame's rows over N
processes (:func:`maybe_spatial_context`, :func:`spatial_frame_targets`,
the JAX package's): the style Grams are made whole on every rank, each
frame's content targets in rows, and the update is the row-sharded
loss's. :func:`stylize_sequence` starts the ranks itself
(``parallel.mesh.launch``); rank 0 makes frame 0's start and writes
every file, each frame gathered to it after its steps.
"""
from __future__ import annotations

import re
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.engine.coarse import (
    coarse_init,
    resolve_coarse_steps,
)
from style_transfer_visualizer_tpu_torch.engine.step import (
    chunked,
    drive_chunked,
    make_objective,
    refill,
    targets_update,
)
from style_transfer_visualizer_tpu_torch.media import encode
from style_transfer_visualizer_tpu_torch.media.decode import (
    extract_frames,
    is_video_file,
    probe_video,
)
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream
from style_transfer_visualizer_tpu_torch.main import (
    check_spatial,
    sharded_content_feats,
    spatial_loss,
)
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    compute_content_targets,
    compute_targets,
    initialize_input,
    targets_maybe_blended,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)
from style_transfer_visualizer_tpu_torch.ops.color import maybe_restore_color
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.ops.precision import (
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.parallel.mesh import Mesh, launch
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from collections.abc import Callable

    from style_transfer_visualizer_tpu_torch.config import StyleTransferConfig
    from style_transfer_visualizer_tpu_torch.media.sinks import VideoFrameSink
    from style_transfer_visualizer_tpu_torch.models.vgg19 import Params

# A frame's step budget runs in chunks of at most this many steps, as in
# the JAX package (its cap on one compiled dispatch); the last chunk's
# metrics are the frame's.
_SEQUENCE_MAX_CHUNK = 50

# At most this many PNG saves in flight: the frame stream's queue
# depth, so a slow encoder holds the optimizer back instead of piling
# up frames.
_MAX_PENDING_SAVES = 4

_FRAME_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")


@dataclass(frozen=True)
class SequenceResult:
    """Outcome of a sequence run.

    ``frame_seconds[i]`` is frame i's critical-path wall time (decode
    wait, targets, optimization, PNG hand-off); decodes and PNG encodes
    overlap the device work on worker threads, so they appear here only
    when they outrun the optimizer. ``frame_losses[i]`` is frame i's
    final total loss: warm-started frames (1..) end lower than frame 0
    at equal budgets.
    """

    frame_paths: list[Path]
    total_steps: int
    frame_seconds: tuple[float, ...] = ()
    frame_losses: tuple[float, ...] = ()


def _natural_key(path: Path) -> tuple:
    """Sort key treating digit runs numerically: frame2 < frame10."""
    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", path.name.lower())
    )


def discover_frames(frames_dir: str | Path) -> list[Path]:
    """Image frames in a directory, in natural (temporal) name order.

    Extensions match case-insensitively (camera output is often .JPG)
    and digit runs sort numerically, so unpadded names keep their
    temporal order: the warm-start chain depends on it.
    """
    frames_dir = Path(frames_dir)
    if not frames_dir.is_dir():
        msg = f"Frames directory not found: {frames_dir}"
        raise FileNotFoundError(msg)
    frames = sorted(
        (
            p
            for p in frames_dir.iterdir()
            if p.is_file() and p.suffix.lower() in _FRAME_SUFFIXES
        ),
        key=_natural_key,
    )
    if not frames:
        msg = f"No image frames found under {frames_dir}"
        raise ValueError(msg)
    return frames


@dataclass(frozen=True)
class SpatialContext:
    """A row-sharded sequence's or sweep's mesh and loss.

    The single run's spatial path (``main._prepare_spatial``) for
    frames: ``loss_fn`` is ``main.spatial_loss`` at the whole frame's
    ``shape``.
    """

    mesh: Mesh
    loss_fn: Callable
    n_space: int
    shape: tuple[int, ...]

    @property
    def rows_shape(self) -> tuple[int, ...]:
        """The shape of one rank's rows of a frame."""
        b, h, w, c = self.shape
        return (b, h // self.n_space, w, c)


def maybe_spatial_context(
    config: StyleTransferConfig,
    params: Params,
    image_shape: tuple[int, ...],
    mesh: Mesh | None,
) -> SpatialContext | None:
    """A :class:`SpatialContext` when ``spatial_shards > 1``, else None.

    The frames run the mesh loss, so the memory layout asked for is
    the one run; the divisibility checks raise here.
    """
    if not check_spatial(config, mesh):
        return None
    loss_fn = spatial_loss(config, params, image_shape, mesh)
    logger.info("Spatial sharding: frame rows over %d ranks.", mesh.size)
    return SpatialContext(
        mesh=mesh, loss_fn=loss_fn, n_space=mesh.size,
        shape=tuple(image_shape),
    )


def spatial_frame_targets(
    spatial: SpatialContext,
    params: Params,
    content: torch.Tensor,
    style_grams: dict[int, torch.Tensor],
    config: StyleTransferConfig,
) -> Targets:
    """A sharded frame's targets: ``style_grams`` (replicated), the
    content features of this rank's rows of the whole frame
    ``content``, and with ``lap_w`` this rank's rows of the frame's
    padded Laplacian target (``main.sharded_content_feats``)."""
    return Targets(
        style_grams=style_grams,
        content_feats=sharded_content_feats(
            config, params, content, spatial.mesh,
        ),
    )


def spatial_start(spatial: SpatialContext | None, make_start):
    """A frame's starting image: ``make_start()``, or on a mesh rank
    0's ``make_start()`` handed to every rank, each keeping its rows.

    ``make_start`` returns the whole image; on a mesh the other ranks
    do not call it.
    """
    if spatial is None:
        return make_start()
    mesh = spatial.mesh
    start = make_start() if mesh.is_root else None
    like = torch.empty(spatial.shape, device=mesh.device)
    return mesh.shard(mesh.broadcast(start, like=like))


def build_targets_update(
    params: Params,
    image_shape: tuple[int, ...],
    cfg: StyleTransferConfig,
    loss_fn: Callable | None = None,
    mesh: Mesh | None = None,
):
    """``(update, update_many, init_state, run_params)``, targets as
    arguments.

    ``update(x, state, params, targets) -> (x, state, StepAux)`` and
    ``update_many(x, state, params, targets, k)`` (``k`` steps, the
    metrics stacked along a leading ``k`` axis; an
    ``engine.step.GraphedChunk``, CUDA-graph replays on the card, so
    targets that change between calls go through
    ``engine.step.refill``) take the weights and the targets on every
    call; ``init_state()`` makes a fresh optimizer state on the
    weights' device (``init_state(state)`` resets ``state`` in place);
    ``run_params`` are the weights to pass. By default the objective
    is the single run's (``engine.step.make_objective`` with ``cfg``'s
    weights and terms):
    with ``lap_w`` set, ``targets`` is then the pair ``(Targets,
    lap_target)``, so a sequence holds each frame to its own source's
    Laplacian. ``loss_fn(params, image, targets) -> (total, (style,
    content))`` replaces it (the regional run's); ``targets`` is then
    whatever that function takes. The default objective runs at
    ``cfg.hardware.precision``, resolved here. With ``mesh`` (a
    row-sharded ``loss_fn``) ``image_shape`` is one rank's rows and
    ``update_many`` dispatches eagerly (``engine.step.EagerChunk``).
    """
    opt = cfg.optimization
    if loss_fn is None:
        loss_fn = make_objective(
            style_w=opt.style_w,
            content_w=opt.content_w,
            tv_w=opt.tv_w,
            lap_w=opt.lap_w,
            lap_pool=opt.lap_pool,
            style_layers=tuple(opt.style_layers),
            content_layers=tuple(opt.content_layers),
            style_weights=opt.style_weights_tuple(),
            precision=resolve_precision(cfg.hardware.precision),
        )
    update, init_state = targets_update(
        loss_fn,
        tuple(image_shape),
        next(iter(params.values()))["w9"].device,
        optimizer=opt.optimizer,
        lr=opt.lr,
        lbfgs_max_iter=opt.lbfgs_max_iter,
        lbfgs_max_eval=opt.lbfgs_max_eval,
        lbfgs_history_size=opt.lbfgs_history_size,
        lbfgs_history_dtype=opt.lbfgs_history_dtype,
        lbfgs_direction=opt.lbfgs_direction,
        mesh=mesh,
    )
    return update, chunked(update, mesh), init_state, params


def _resolve_frame_source(
    frames_source: str | Path,
    output_dir: Path,
    *,
    max_frames: int | None,
    frame_stride: int,
) -> tuple[list[Path], Path | None, float | None]:
    """Frames to stylize, from a directory or a decodable clip file.

    Returns ``(frames, extracted_dir, source_fps)``: ``extracted_dir``
    is a temporary directory the caller removes when the input was a
    clip, and ``source_fps`` is the clip's own frame rate (None for a
    directory).
    """
    if is_video_file(frames_source):
        info = probe_video(frames_source)
        extracted_dir = Path(
            tempfile.mkdtemp(prefix="_decoded_frames_", dir=output_dir),
        )
        frames = extract_frames(
            frames_source, extracted_dir,
            max_frames=max_frames, stride=frame_stride,
        )
        return frames, extracted_dir, info.fps
    frames = discover_frames(frames_source)
    if frame_stride > 1:
        frames = frames[::frame_stride]
    if max_frames is not None:
        frames = frames[:max_frames]
    if not frames:
        msg = f"No frames left from {frames_source} after striding/capping"
        raise ValueError(msg)
    return frames, None, None


def _append_png_frames(sink: VideoFrameSink, frame_files: list[Path]):
    """Feed saved PNG frames into a video sink, closing it afterward."""
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    try:
        for frame_file in frame_files:
            with Image.open(frame_file) as img:
                sink.append_data(
                    np.asarray(img.convert("RGB"), dtype=np.uint8),
                )
    finally:
        sink.close()


def assemble_output_video(
    outputs: list[Path],
    video_path: Path,
    fps: float,
    config: StyleTransferConfig,
) -> None:
    """Encode stylized frames into ``video_path`` (.gif or .mp4 class)."""
    suffix = video_path.suffix.lower()
    if suffix == ".gif":
        sink = encode.GifFrameCollector(video_path, fps)
    elif suffix in (".mp4", ".mov", ".mkv", ".webm"):
        # VideoConfig.fps is a bounded int; the encoder takes the
        # clamped value while GIFs keep the exact source rate.
        sink = encode.FfmpegPipeWriter(
            replace(config.video, fps=max(1, min(60, round(fps)))),
            video_path,
        )
    else:
        msg = (
            f"Unsupported --output-video suffix {suffix!r} "
            "(use .gif or .mp4/.mov/.mkv/.webm)"
        )
        raise ValueError(msg)
    _append_png_frames(sink, outputs)
    logger.info("Sequence video saved to: %s", video_path)


def stylize_sequence(
    frames_dir: str | Path,
    style_path: str | Path,
    config: StyleTransferConfig,
    output_dir: str | Path,
    *,
    params: Params | None = None,
    assemble_gif: bool = False,
    style_blend: list[tuple[str | Path, float]] | None = None,
    output_video: str | None = None,
    output_fps: float | None = None,
    max_frames: int | None = None,
    frame_stride: int = 1,
    mesh: Mesh | None = None,
) -> SequenceResult:
    """Stylize every frame of ``frames_dir`` against one style image.

    ``frames_dir`` names a directory of frames or a clip file (GIF,
    WebP and APNG through Pillow, MP4-class containers through ffmpeg;
    ``media/decode.py``), decoded into a temporary directory first.
    Each frame gets ``config.optimization.steps`` steps and is saved as
    ``stylized_{frame_stem}.png`` under ``output_dir``; with
    ``assemble_gif`` the frames also make ``stylized_sequence.gif`` at
    ``config.video.fps``. ``output_video`` (``.gif`` or an ffmpeg
    container) is assembled under ``output_dir`` at ``output_fps``, by
    default the source clip's rate for a clip, else
    ``config.video.fps``. ``frame_stride`` keeps every stride-th frame,
    then ``max_frames`` caps the count.

    ``style_blend``, ``(path, weight)`` pairs, optimizes the clip
    against the weighted Gram mixture of the styles (the coarse warm
    start blends the same styles); ``style_path`` still names the
    primary style. The style Grams are computed once for the clip.
    ``preserve_color="match"`` remaps the styles onto frame 0's colors;
    ``"luminance"`` recolors each stylized frame with its own source
    frame's chrominance. ``params`` reuses weights already on the
    run's device. Runs on ``config.hardware.device``. With
    ``spatial_shards > 1`` and no ``mesh`` it starts the ranks (each
    loads its own weights; ``params`` stays here) and returns rank 0's
    result; with a ``mesh`` it is that rank's part.
    """
    config.validate()
    if check_spatial(config, mesh) and mesh is None:
        return launch(
            stylize_sequence, (frames_dir, style_path, config, output_dir),
            config.hardware.spatial_shards, config.hardware.device,
            kwargs={
                "assemble_gif": assemble_gif, "style_blend": style_blend,
                "output_video": output_video, "output_fps": output_fps,
                "max_frames": max_frames, "frame_stride": frame_stride,
            },
        )
    writes = mesh is None or mesh.writes
    opt = config.optimization
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    frames, extracted_dir, source_fps = _resolve_frame_source(
        frames_dir, output_dir,
        max_frames=max_frames, frame_stride=frame_stride,
    )
    try:
        device = (
            mesh.device if mesh is not None
            else setup_device(config.hardware.device)
        )
        generator = setup_random_seed(opt.seed, device)
        if params is None:
            params = load_pretrained_params(
                device, arch=get_architecture(opt.model),
                allow_random=opt.allow_random_weights, seed=opt.seed,
            )
        first_host = image_io.load_image_to_host_array(frames[0])
        match_to = first_host if opt.preserve_color == "match" else None
        style_img = image_io.load_style_image_to_array(
            style_path, device, normalize=opt.normalize, match_to=match_to,
        )
        blend_imgs = None
        if style_blend:
            blend_imgs = [
                (
                    image_io.load_style_image_to_array(
                        path, device, normalize=opt.normalize,
                        match_to=match_to,
                    ),
                    float(weight),
                )
                for path, weight in style_blend
            ]
        first_content = image_io.host_array_to_device(
            first_host, device, normalize=opt.normalize,
        )
        spatial = maybe_spatial_context(
            config, params, tuple(first_content.shape), mesh,
        )
        _, update_many, init_state, run_params = build_targets_update(
            params,
            tuple(first_content.shape) if spatial is None
            else spatial.rows_shape,
            config,
            loss_fn=None if spatial is None else spatial.loss_fn,
            mesh=mesh,
        )
        style_layers = tuple(opt.style_layers)
        # The style Grams are the clip's: made once; each frame makes
        # only its content targets.
        precision = resolve_precision(config.hardware.precision)
        base_targets = targets_maybe_blended(
            lambda s_img, c_layers: compute_targets(
                params, s_img, first_content, style_layers, c_layers,
                precision,
            ),
            style_img,
            # A sharded run takes every frame's features in rows.
            tuple(opt.content_layers) if spatial is None else (),
            blend_imgs,
        )
        outputs, frame_seconds, frame_losses, total_steps = _stylize_frames(
            frames, first_content, base_targets, config,
            update_many, init_state, run_params,
            style_img=style_img, blend_imgs=blend_imgs,
            generator=generator, output_dir=output_dir,
            first_host=first_host, spatial=spatial,
        )
    finally:
        if extracted_dir is not None:
            shutil.rmtree(extracted_dir, ignore_errors=True)

    if assemble_gif and outputs and writes:
        gif_path = output_dir / "stylized_sequence.gif"
        _append_png_frames(
            encode.GifFrameCollector(gif_path, config.video.fps), outputs,
        )
        logger.info("Sequence GIF saved to: %s", gif_path)
    if output_video and outputs and writes:
        fps = output_fps or source_fps or float(config.video.fps)
        assemble_output_video(
            outputs, output_dir / output_video, fps, config,
        )
    return SequenceResult(
        frame_paths=outputs,
        total_steps=total_steps,
        frame_seconds=tuple(frame_seconds),
        frame_losses=tuple(frame_losses),
    )


def _png_writer(path: Path) -> Callable[[np.ndarray], None]:
    """A frame-stream callback that saves its (H, W, 3) uint8 frame."""

    def save(frame: np.ndarray) -> None:
        from PIL import Image  # noqa: PLC0415 - optional, file I/O only

        Image.fromarray(frame, mode="RGB").save(path)

    return save


def _frame_targets(
    params: Params,
    content: torch.Tensor,
    base_targets: Targets,
    config: StyleTransferConfig,
    *,
    first: bool,
):
    """A frame's targets: the clip's Grams, the frame's content.

    Frame 0's content targets came with the Grams. With ``lap_w`` set,
    the pair ``(Targets, lap_target)`` of the frame's own response.
    """
    opt = config.optimization
    targets = base_targets
    if not first:
        targets = Targets(
            style_grams=base_targets.style_grams,
            content_feats=compute_content_targets(
                params, content, tuple(opt.content_layers),
                resolve_precision(config.hardware.precision),
            ),
        )
    if opt.lap_w:
        # Each frame pins its edges to its own source frame.
        return targets, lap_response(content, opt.lap_pool)
    return targets


def _first_image(
    params: Params,
    content: torch.Tensor,
    config: StyleTransferConfig,
    *,
    style_img: torch.Tensor,
    blend_imgs,
    generator: torch.Generator,
) -> torch.Tensor:
    """Frame 0's starting image: the warm start when it runs, else
    ``init_method``.

    Frame 0 is the clip's only cold start; later frames warm from the
    previous result, so the coarse warm start applies to frame 0 only
    (auto resolved against the frame's size and written back).
    """
    opt = config.optimization
    opt.coarse_steps = resolve_coarse_steps(
        opt.coarse_steps, int(content.shape[1]), int(content.shape[2]),
        opt.steps,
    )
    x = None
    if opt.coarse_steps > 0:
        x = coarse_init(
            params, content, style_img, config, generator,
            blend_imgs=blend_imgs,
        )
    if x is None:
        x = initialize_input(content, opt.init_method, generator)
    return x


def _stylize_frames(
    frames: list[Path],
    first_content: torch.Tensor,
    base_targets: Targets,
    config: StyleTransferConfig,
    update_many: Callable,
    init_state: Callable,
    run_params: Params,
    *,
    style_img: torch.Tensor,
    blend_imgs,
    generator: torch.Generator,
    output_dir: Path,
    first_host: np.ndarray,
    spatial: SpatialContext | None = None,
) -> tuple[list[Path], list[float], list[float], int]:
    """The per-frame warm-start loop; returns the run's telemetry.

    ``first_host``, frame 0 as a (1, H, W, 3) [0, 1] host array, is
    also the ``preserve_color="luminance"`` chrominance of frame 0;
    each later frame's is its own. With ``spatial`` the image is this
    rank's rows; each frame is gathered to rank 0, which saves it.
    """
    opt = config.optimization
    device = first_content.device
    keep_luminance = opt.preserve_color == "luminance"
    outputs: list[Path] = []
    frame_seconds: list[float] = []
    frame_losses: list[float] = []
    total_steps = 0
    x: torch.Tensor | None = None
    held = state = None
    decoder = ThreadPoolExecutor(max_workers=1, thread_name_prefix="stv-seq")
    saver = AsyncFrameStream(max_queue=_MAX_PENDING_SAVES)
    next_decode = None
    try:
        for i, frame_path in enumerate(frames):
            frame_start = time.perf_counter()
            prefetch = None
            if i + 1 < len(frames):
                prefetch = decoder.submit(
                    image_io.load_image_to_host_array, frames[i + 1],
                )
            if i == 0:
                content_host, content = first_host, first_content
            else:
                # The previous iteration prefetched every frame past 0.
                content_host = next_decode.result()
                content = image_io.host_array_to_device(
                    content_host, device, normalize=opt.normalize,
                )
            next_decode = prefetch
            if content.shape != first_content.shape:
                msg = (
                    f"Frame {frame_path.name} has shape "
                    f"{tuple(content.shape)}; all frames must match the "
                    f"first ({tuple(first_content.shape)})"
                )
                raise ValueError(msg)
            if spatial is None:
                targets = _frame_targets(
                    run_params, content, base_targets, config, first=i == 0,
                )
            else:
                targets = spatial_frame_targets(
                    spatial, run_params, content, base_targets.style_grams,
                    config,
                )
            if x is None:
                x = spatial_start(spatial, lambda content=content: (
                    _first_image(
                        run_params, content, config, style_img=style_img,
                        blend_imgs=blend_imgs, generator=generator,
                    )
                ))
            # else: the warm start, x carried over from the last frame.
            # The captured step reads its targets and state where they
            # are: this frame's targets are copied into those held,
            # and the optimizer restarts in place.
            held = refill(held, targets)
            state = init_state(state)
            x, state, auxes = drive_chunked(
                lambda img, st, k: update_many(img, st, run_params, held, k),
                x, state, opt.steps, min(opt.steps, _SEQUENCE_MAX_CHUNK),
            )
            total_steps += opt.steps

            out_path = output_dir / f"stylized_{frame_path.stem}.png"
            whole = x if spatial is None else spatial.mesh.gather(x)
            chroma = (
                image_io.host_array_to_device(content_host, device)
                if keep_luminance
                else None
            )
            # A fresh uint8 tensor that no later step writes, copied to
            # the host behind this frame's steps.
            if spatial is None or spatial.mesh.writes:
                saver.submit(
                    image_io.pack_uint8_frame(
                        maybe_restore_color(
                            image_io.prepare_image_for_output(
                                whole, normalize=opt.normalize,
                            ),
                            chroma,
                        ),
                    ),
                    _png_writer(out_path),
                )
            outputs.append(out_path)
            # The frame's one host read: it waits for this frame's
            # device work, so the frame time is the critical path.
            frame_losses.append(float(auxes.loss[-1]))
            frame_seconds.append(time.perf_counter() - frame_start)
            logger.info(
                "Frame %d/%d stylized (loss %.4g, %.2fs): %s",
                i + 1, len(frames), frame_losses[-1], frame_seconds[-1],
                out_path,
            )
    finally:
        decoder.shutdown(wait=True)
        # Every save lands (or raises) before a caller reads the files.
        saver.close()
    return outputs, frame_seconds, frame_losses, total_steps
