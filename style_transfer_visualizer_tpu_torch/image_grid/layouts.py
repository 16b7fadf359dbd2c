"""Layout orchestration for grids and gallery walls.

The port's own copy of the JAX package's ``image_grid/layouts.py``.
Two families:
- ``make_horizontal_grid``: plain N-panel row on a flat background,
  tight-sized or centered on an exact canvas.
- ``make_gallery_comparison``: framed panels on a lit wall, either
  two-across (content | style) or stacked-left (content/style column plus
  a tall result panel occupying the right 58%).
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import replace
from typing import TYPE_CHECKING


from style_transfer_visualizer_tpu_torch.constants import (
    COLOR_BLACK,
    COLOR_GREY,
    COLOR_WHITE,
    RESOLUTION_FULL_HD,
)
from style_transfer_visualizer_tpu_torch.image_grid.core import (
    DEFAULT_HEIGHT,
    DEFAULT_PAD,
    FRAME_TEXTURE_MAX,
    RGB,
    FrameParams,
    Rect,
    build_framed_panel,
    content_dimensions,
    draw_border,
    draw_label,
    fit_box_by_inner_aspect,
    make_wall_canvas,
    paste_horizontally,
    scale_images_to_fit_canvas,
    scale_images_to_target,
    to_rgb,
)

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.type_defs import LayoutName

_CONTENT_IDX, _STYLE_IDX, _RESULT_IDX = 0, 1, 2
_GAP_FRACTION = 0.02
_LEFT_COLUMN_FRACTION = 0.42
_RESULT_INSET_FRACTION = 0.06


def make_horizontal_grid(
    images: Sequence[Image.Image],
    *,
    target_height: int | None = DEFAULT_HEIGHT,
    target_size: tuple[int, int] | None = None,
    pad: int = DEFAULT_PAD,
    bg_color: RGB = COLOR_WHITE,
    border_px: int = 0,
) -> Image.Image:
    """Compose a horizontal row of panels.

    With ``target_size`` the row is scaled down (never up) to fit and
    centered on an exact canvas; otherwise the canvas is sized tightly
    around height-normalized panels.
    """
    from PIL import Image  # noqa: PLC0415

    if not images:
        msg = "No images provided"
        raise ValueError(msg)

    panels = [to_rgb(im, bg_color=bg_color) for im in images]
    panels = scale_images_to_target(panels, target_height, target_size)
    panels = [draw_border(im, border_px) for im in panels]

    row_w, row_h, _, _ = content_dimensions(panels, pad)
    tight_w = row_w + 2 * pad
    tight_h = row_h + 2 * pad

    if target_size is None:
        canvas_w, canvas_h = tight_w, tight_h
        start = (pad, pad)
    else:
        panels, row_w, row_h = scale_images_to_fit_canvas(
            panels, pad, tight_w, tight_h, target_size,
        )
        canvas_w, canvas_h = target_size
        start = ((canvas_w - row_w) // 2, (canvas_h - row_h) // 2)

    canvas = Image.new("RGB", (canvas_w, canvas_h), bg_color)
    paste_horizontally(canvas, panels, pad, start, row_h)
    return canvas


def _boxes_two_across(
    w: int,
    h: int,
    *,
    lr_margin: int,
    tb_margin: int,
    gap_frac: float,
) -> list[Rect]:
    """Two equal panels side by side, vertically centered."""
    gap = int(w * gap_frac)
    panel_w = (w - 2 * lr_margin - gap) // 2
    panel_h = h - 2 * tb_margin
    y0 = (h - panel_h) // 2
    left = Rect(lr_margin, y0, lr_margin + panel_w, y0 + panel_h)
    right_x0 = lr_margin + panel_w + gap
    return [left, Rect(right_x0, y0, right_x0 + panel_w, y0 + panel_h)]


def _boxes_stacked_left(
    w: int,
    h: int,
    *,
    lr_margin: int,
    tb_margin: int,
    gap_frac: float,
    left_col_frac: float,
) -> list[Rect]:
    """Two stacked panels on the left, one tall panel on the right."""
    gap = int(w * gap_frac)
    usable_w = w - 2 * lr_margin - gap
    col_w = int(usable_w * left_col_frac)
    right_w = usable_w - col_w
    usable_h = h - 2 * tb_margin
    top_h = (usable_h - gap) // 2
    bottom_h = usable_h - gap - top_h

    x0, y0 = lr_margin, tb_margin
    return [
        Rect(x0, y0, x0 + col_w, y0 + top_h),
        Rect(x0, y0 + top_h + gap, x0 + col_w,
             y0 + top_h + gap + bottom_h),
        Rect(x0 + col_w + gap, y0, x0 + col_w + gap + right_w,
             y0 + usable_h),
    ]


def _render_panels(
    canvas: Image.Image,
    images: list[Image.Image],
    boxes: list[Rect],
    fparams: FrameParams,
    *,
    wall_color: RGB,
    two_image: bool,
) -> list[tuple[int, int]]:
    """Paint framed panels; return canvas-space label anchors."""
    anchors: list[tuple[int, int]] = []
    for idx, (im, box) in enumerate(zip(images, boxes, strict=True)):
        local = fparams
        if two_image or idx == _RESULT_IDX:
            local = replace(fparams, fit_mode="contain")
        panel, anchor = build_framed_panel(
            to_rgb(im, bg_color=COLOR_BLACK),
            box.size(),
            local,
            wall_color=wall_color,
        )
        anchors.append((box.x0 + anchor[0], box.y0 + anchor[1]))
        canvas.paste(panel, (box.x0, box.y0))
    return anchors


def _clamped_frame_params(frame: FrameParams | None) -> FrameParams:
    """Texture strength bounded into its safe range."""
    fparams = frame or FrameParams()
    strength = min(
        FRAME_TEXTURE_MAX, max(0, fparams.frame_texture_strength),
    )
    if strength == fparams.frame_texture_strength:
        return fparams
    return replace(fparams, frame_texture_strength=strength)


def _safe_margin(margin: int, dim: int) -> int:
    """Degrade fixed wall margins only on tiny canvases.

    Keeps the fixed 48px margins wherever they leave room; below that,
    fixed margins would consume most of the dimension.
    """
    return margin if 2 * margin <= dim * 3 // 4 else dim // 8


def _plan_panels(
    *,
    two_image: bool,
    w: int,
    h: int,
    lr_margin: int,
    tb_margin: int,
    content: Image.Image,
    style: Image.Image,
    result: Image.Image | None,
    labels: tuple[str, str, str],
    fparams: FrameParams,
) -> tuple[list[Image.Image], list[Rect], tuple[str, ...]]:
    """Choose panel images, fitted boxes, and label texts for the layout."""
    if two_image:
        imgs: list[Image.Image] = [content, style]
        raw_boxes = _boxes_two_across(
            w, h, lr_margin=lr_margin, tb_margin=tb_margin,
            gap_frac=_GAP_FRACTION,
        )
        # Both panels fit to their image's aspect.
        boxes = [
            fit_box_by_inner_aspect(
                box, im, fparams, _RESULT_INSET_FRACTION,
            )
            for box, im in zip(raw_boxes, imgs, strict=True)
        ]
        return imgs, boxes, labels[:2]

    imgs = [content, style, result]  # type: ignore[list-item]
    boxes = _boxes_stacked_left(
        w, h, lr_margin=lr_margin, tb_margin=tb_margin,
        gap_frac=_GAP_FRACTION, left_col_frac=_LEFT_COLUMN_FRACTION,
    )
    # Only the result column fits to its image's aspect.
    boxes[_RESULT_IDX] = fit_box_by_inner_aspect(
        boxes[_RESULT_IDX], imgs[_RESULT_IDX],
        fparams, _RESULT_INSET_FRACTION,
    )
    return imgs, boxes, labels


def make_gallery_comparison(
    content: Image.Image,
    style: Image.Image,
    result: Image.Image | None,
    *,
    target_size: tuple[int, int] = RESOLUTION_FULL_HD,
    layout: LayoutName = "gallery-stacked-left",
    wall_color: RGB = COLOR_GREY,
    frame: FrameParams | None = None,
    labels: tuple[str, str, str] = ("Content", "Style", "Final"),
    left_right_wall_margin: int = 48,
    top_bottom_wall_margin: int = 48,
) -> Image.Image:
    """Render the gallery-wall comparison image.

    Falls back to the two-panel layout when ``result`` is None regardless
    of ``layout``.
    """
    w, h = target_size
    if w <= 0 or h <= 0:
        msg = "target_size must be positive"
        raise ValueError(msg)

    fparams = _clamped_frame_params(frame)
    imgs, boxes, labs = _plan_panels(
        two_image=(result is None) or (layout == "gallery-two-across"),
        w=w,
        h=h,
        lr_margin=_safe_margin(left_right_wall_margin, w),
        tb_margin=_safe_margin(top_bottom_wall_margin, h),
        content=content,
        style=style,
        result=result,
        labels=labels,
        fparams=fparams,
    )

    canvas = make_wall_canvas(
        (w, h), wall_color, vignette=True, noise=True,
    )
    anchors = _render_panels(
        canvas, imgs, boxes, fparams,
        wall_color=wall_color, two_image=len(imgs) == 2,
    )

    if fparams.label is not None:
        for text, center in zip(labs, anchors, strict=True):
            draw_label(
                canvas,
                center=center,
                text=text,
                px=fparams.label_px,
                fill=fparams.label_fill,
                y_offset=fparams.label_offset_px,
            )

    return canvas
