"""Rendering primitives for gallery-wall compositing (Pillow, host).

The port's own copy of the JAX package's ``image_grid/core.py``: a wall
canvas with vertical lighting gradient, vignette and optional noise;
framed panels with three tone bands, bevel highlights, wood-streak
texture, beige matte, and a Gaussian drop shadow; and centered labels
with a 1px shadow. Geometry helpers solve panel boxes whose *inner
opening* matches an image's aspect ratio via a short fixed-point
iteration. The same Pillow calls in the same order give the same
pixels as the JAX package (``Image.effect_noise`` is unseeded, so two
renders agree only where its draws do). Pillow is imported inside the
functions that draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Literal


from style_transfer_visualizer_tpu_torch.constants import (
    COLOR_BEIGE,
    COLOR_BLACK,
    COLOR_WHITE,
)

RGB = tuple[int, int, int]

FRAME_TEXTURE_MAX = 100
DEFAULT_HEIGHT = 512
DEFAULT_PAD = 16

_MIN_OUTER_BAND_PX = 3
_MIN_INNER_BAND_PX = 2
_BEVEL_ALPHA_MAX = 120
_SHADOW_ALPHA = 130
_NOISE_SCALE = 8.0
_NOISE_BLUR_RADIUS = 2
_TEXTURE_BLEND_CAP = 0.25
_ASPECT_FIT_ITERATIONS = 6
_WALL_LUMA_CENTER = 220
_WALL_LUMA_RANGE = 20
_VIGNETTE_MARGIN_FRAC = 0.06

_TONE_BANDS: dict[str, tuple[RGB, RGB, RGB]] = {
    "gold": ((110, 85, 35), (170, 140, 70), (80, 60, 25)),
    "oak": ((115, 85, 45), (150, 115, 70), (90, 65, 35)),
    "black": ((25, 25, 25), (40, 40, 40), (15, 15, 15)),
}


def to_rgb(img: Image.Image, *, bg_color: RGB) -> Image.Image:
    """Convert to RGB, compositing alpha over ``bg_color`` when present."""
    from PIL import Image  # noqa: PLC0415

    if img.mode == "RGB":
        return img
    if img.mode in ("RGBA", "LA"):
        backdrop = Image.new("RGBA", img.size, (*bg_color, 255))
        return Image.alpha_composite(backdrop, img.convert("RGBA")).convert(
            "RGB",
        )
    return img.convert("RGB")


def resize_to_height(img: Image.Image, height: int) -> Image.Image:
    """Aspect-preserving resize to an exact height."""
    from PIL import Image  # noqa: PLC0415

    w, h = img.size
    if h <= 0:
        msg = "Input image has zero height"
        raise ValueError(msg)
    new_w = max(1, round(w * height / h))
    return img.resize((new_w, height), Image.Resampling.LANCZOS)


def draw_border(img: Image.Image, border_px: int) -> Image.Image:
    """Surround the image with a black border, if requested."""
    from PIL import ImageOps  # noqa: PLC0415

    if border_px <= 0:
        return img
    return ImageOps.expand(img, border=border_px, fill=COLOR_BLACK)


def scale_images_to_target(
    images: list[Image.Image],
    target_height: int | None,
    target_size: tuple[int, int] | None,
) -> list[Image.Image]:
    """Height-normalize panels unless an exact canvas size drives layout."""
    if target_size is not None and target_height is None:
        return images
    height = target_height or DEFAULT_HEIGHT
    return [resize_to_height(im, height) for im in images]


def content_dimensions(
    images: list[Image.Image],
    pad: int,
) -> tuple[int, int, list[int], list[int]]:
    """Tight row dimensions for horizontally arranged panels."""
    widths = [im.size[0] for im in images]
    heights = [im.size[1] for im in images]
    row_w = sum(widths) + pad * (len(images) - 1)
    row_h = max(heights) if heights else 0
    return row_w, row_h, widths, heights


def scale_images_to_fit_canvas(
    images: list[Image.Image],
    pad: int,
    tight_w: int,
    tight_h: int,
    target_size: tuple[int, int],
) -> tuple[list[Image.Image], int, int]:
    """Uniformly downscale panels so the tight row fits the canvas."""
    from PIL import Image  # noqa: PLC0415

    scale = min(
        1.0, target_size[0] / tight_w, target_size[1] / tight_h,
    )
    if scale >= 1.0:
        row_w, row_h, _, _ = content_dimensions(images, pad)
        return images, row_w, row_h
    scaled = [
        im.resize(
            (
                max(1, round(im.size[0] * scale)),
                max(1, round(im.size[1] * scale)),
            ),
            Image.Resampling.LANCZOS,
        )
        for im in images
    ]
    row_w, row_h, _, _ = content_dimensions(scaled, pad)
    return scaled, row_w, row_h


def paste_horizontally(
    canvas: Image.Image,
    images: list[Image.Image],
    pad: int,
    start_xy: tuple[int, int],
    row_height: int,
) -> None:
    """Paste panels left-to-right, vertically centered within the row."""
    x, y = start_xy
    for im in images:
        canvas.paste(im, (x, y + (row_height - im.size[1]) // 2))
        x += im.size[0] + pad


@dataclass(frozen=True)
class FrameParams:
    """Appearance knobs for a framed panel."""

    matte_frac: float = 0.0
    frame_outer_frac: float = 0.035
    frame_inner_frac: float = 0.02
    bevel_px: int = 3
    shadow_radius: int = 12
    shadow_offset: tuple[int, int] = (6, 6)
    frame_tone: str = "gold"
    fit_mode: Literal["cover", "contain"] = "cover"
    frame_texture_strength: int = 18
    label: str | None = None
    label_px: int = 30
    label_fill: RGB = (235, 235, 235)
    label_offset_px: int = 2


@dataclass(frozen=True)
class Rect:
    """Integer rectangle with layout helpers."""

    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def w(self) -> int:
        """Width."""
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        """Height."""
        return self.y1 - self.y0

    def size(self) -> tuple[int, int]:
        """(width, height)."""
        return self.w, self.h

    def inset(self, dx: int, dy: int) -> Rect:
        """Copy shrunk by (dx, dy) on every side."""
        return Rect(self.x0 + dx, self.y0 + dy, self.x1 - dx, self.y1 - dy)


def _band_thickness(
    panel_w: int,
    panel_h: int,
    params: FrameParams,
) -> tuple[int, int, int]:
    """Per-side (matte, outer, inner) band thickness in pixels."""
    short_side = min(panel_w, panel_h)
    matte = max(0, round(params.matte_frac * short_side))
    outer = max(
        _MIN_OUTER_BAND_PX, round(params.frame_outer_frac * short_side),
    )
    inner = max(
        _MIN_INNER_BAND_PX, round(params.frame_inner_frac * short_side),
    )
    return matte, outer, inner


def _margin_px(params: FrameParams, panel_w: int, panel_h: int) -> int:
    matte, outer, inner = _band_thickness(panel_w, panel_h, params)
    return matte + outer + inner


def fit_box_by_inner_aspect(
    box: Rect,
    img: Image.Image,
    params: FrameParams,
    inset_frac: float,
) -> Rect:
    """Shrink ``box`` so the frame's inner opening matches ``img`` aspect.

    The margin depends on the panel size which depends on the margin, so
    the solution is found by a few fixed-point iterations.
    """
    if img.size[1] <= 0:
        msg = "Image height must be positive"
        raise ValueError(msg)
    aspect = img.size[0] / img.size[1]
    avail = box.inset(
        int(box.w * inset_frac / 2), int(box.h * inset_frac / 2),
    )
    aw, ah = avail.w, avail.h

    pw, ph = aw, ah
    # The fixed-point converges (and breaks) well before the bound:
    for _ in range(_ASPECT_FIT_ITERATIONS):  # pragma: no branch
        margin = _margin_px(params, pw, ph)
        inner_w_max = max(1, aw - 2 * margin)
        inner_h_max = max(1, ah - 2 * margin)
        if inner_w_max / inner_h_max >= aspect:
            inner_h = inner_h_max
            inner_w = round(inner_h * aspect)
        else:
            inner_w = inner_w_max
            inner_h = round(inner_w / aspect)
        new_pw = min(inner_w + 2 * margin, aw)
        new_ph = min(inner_h + 2 * margin, ah)
        if (new_pw, new_ph) == (pw, ph):
            break
        pw, ph = new_pw, new_ph

    x0 = avail.x0 + (aw - pw) // 2
    y0 = avail.y0 + (ah - ph) // 2
    return Rect(x0, y0, x0 + pw, y0 + ph)


def _place_on_matte(
    img: Image.Image,
    inner_size: tuple[int, int],
    matte_px: int,
    *,
    fit_mode: str,
) -> Image.Image:
    """Fill the frame opening (cover-crop or contain-letterbox) on beige."""
    from PIL import Image, ImageOps  # noqa: PLC0415

    if fit_mode == "cover":
        fitted = ImageOps.fit(
            img, inner_size,
            method=Image.Resampling.LANCZOS,
            centering=(0.5, 0.5),
        )
    else:
        scale = min(
            inner_size[0] / img.size[0], inner_size[1] / img.size[1],
        )
        rw = max(1, int(img.size[0] * scale))
        rh = max(1, int(img.size[1] * scale))
        resized = img.resize((rw, rh), Image.Resampling.LANCZOS)
        fitted = Image.new("RGB", inner_size, COLOR_BEIGE)
        fitted.paste(
            resized,
            ((inner_size[0] - rw) // 2, (inner_size[1] - rh) // 2),
        )

    matte = Image.new(
        "RGB",
        (inner_size[0] + 2 * matte_px, inner_size[1] + 2 * matte_px),
        COLOR_BEIGE,
    )
    matte.paste(fitted, (matte_px, matte_px))
    return matte


def _tone_bands(tone: str) -> tuple[RGB, RGB, RGB]:
    return _TONE_BANDS.get(tone.lower(), _TONE_BANDS["gold"])


def _paint_bevel(
    frame_img: Image.Image,
    panel_w: int,
    panel_h: int,
    inset: int,
    bevel: int,
) -> Image.Image:
    """Light top/left edges and darken bottom/right for depth."""
    from PIL import Image, ImageDraw  # noqa: PLC0415

    overlay = Image.new("RGBA", (panel_w, panel_h), (*COLOR_WHITE, 0))
    draw = ImageDraw.Draw(overlay)
    for i in range(bevel):
        alpha = int(_BEVEL_ALPHA_MAX * (1 - i / max(1, bevel)))
        top = inset + i
        right = panel_w - inset - 1 - i
        bottom = panel_h - inset - 1 - i
        draw.rectangle(
            [top, top, right, top], fill=(*COLOR_WHITE, alpha),
        )
        draw.rectangle(
            [top, top, top, bottom], fill=(*COLOR_WHITE, alpha),
        )
        draw.rectangle(
            [top, bottom, right, bottom], fill=(*COLOR_BLACK, alpha // 2),
        )
        draw.rectangle(
            [right, top, right, bottom], fill=(*COLOR_BLACK, alpha // 2),
        )
    return Image.alpha_composite(frame_img, overlay)


def build_framed_panel(
    image: Image.Image,
    panel_box: tuple[int, int],
    params: FrameParams,
    *,
    wall_color: RGB,
) -> tuple[Image.Image, tuple[int, int]]:
    """Compose one framed panel; return it plus the label anchor point."""
    from PIL import Image, ImageDraw, ImageFilter  # noqa: PLC0415

    panel_w, panel_h = panel_box
    base = Image.new("RGBA", (panel_w, panel_h), (*wall_color, 0))

    matte_px, outer, inner = _band_thickness(panel_w, panel_h, params)
    total = matte_px + outer + inner
    inner_w = max(8, panel_w - 2 * total)
    inner_h = max(8, panel_h - 2 * total)

    matte_img = _place_on_matte(
        image, (inner_w, inner_h), matte_px, fit_mode=params.fit_mode,
    )

    frame_img = Image.new("RGBA", (panel_w, panel_h), COLOR_BLACK)
    draw = ImageDraw.Draw(frame_img)
    band1, band2, band3 = _tone_bands(params.frame_tone)
    draw.rectangle([0, 0, panel_w - 1, panel_h - 1], fill=band1)
    draw.rectangle(
        [outer, outer, panel_w - outer - 1, panel_h - outer - 1],
        fill=band2,
    )
    edge = outer + inner
    draw.rectangle(
        [edge, edge, panel_w - edge - 1, panel_h - edge - 1],
        fill=band3,
    )

    bevel = max(0, params.bevel_px)
    if bevel > 0:
        frame_img = _paint_bevel(frame_img, panel_w, panel_h, edge, bevel)

    frame_img = add_frame_texture(
        frame_img, params.frame_texture_strength,
    )
    frame_img.paste(matte_img, (edge, edge))

    shadow = Image.new(
        "RGBA", (panel_w, panel_h), (*COLOR_BLACK, _SHADOW_ALPHA),
    )
    shadow = shadow.filter(
        ImageFilter.GaussianBlur(radius=params.shadow_radius),
    )
    base.alpha_composite(shadow, dest=params.shadow_offset)
    base = Image.alpha_composite(base, frame_img)

    return base.convert("RGB"), (panel_w // 2, panel_h)


@lru_cache(maxsize=8)
def _cached_font(px: int) -> ImageFont.FreeTypeFont | ImageFont.ImageFont:
    from PIL import ImageFont  # noqa: PLC0415

    try:
        return ImageFont.truetype("DejaVuSans.ttf", px)
    except OSError:
        return ImageFont.load_default()


def draw_label(
    canvas: Image.Image,
    center: tuple[int, int],
    text: str,
    px: int,
    fill: RGB,
    *,
    y_offset: int = 0,
) -> None:
    """Draw centered text with a 1px black drop shadow."""
    from PIL import ImageDraw  # noqa: PLC0415

    draw = ImageDraw.Draw(canvas)
    font = _cached_font(px)
    bbox = draw.textbbox((0, 0), text, font=font)
    x = center[0] - (bbox[2] - bbox[0]) // 2
    y = center[1] + y_offset
    draw.text((x + 1, y + 1), text, font=font, fill=COLOR_BLACK)
    draw.text((x, y), text, font=font, fill=fill)


def make_wall_canvas(
    size: tuple[int, int],
    color: RGB,
    *,
    vignette: bool = True,
    noise: bool = False,
) -> Image.Image:
    """Build the wall backdrop: lighting gradient, vignette, faint noise."""
    from PIL import Image, ImageDraw, ImageFilter, ImageOps  # noqa: PLC0415

    w, h = size
    wall = Image.new("RGB", (w, h), color)

    gradient = Image.new("L", (1, h))
    half = h / 2
    gradient.putdata([
        max(0, min(255, int(
            _WALL_LUMA_CENTER
            - _WALL_LUMA_RANGE * abs((y - half) / half),
        )))
        for y in range(h)
    ])
    gradient = gradient.resize((w, h))
    wall = Image.composite(
        wall, Image.new("RGB", (w, h), COLOR_BLACK), gradient,
    )

    if vignette:
        mask = Image.new("L", (w, h), 0)
        margin = int(min(w, h) * _VIGNETTE_MARGIN_FRAC)
        ImageDraw.Draw(mask).rectangle(
            [margin, margin, w - margin, h - margin], fill=255,
        )
        mask = mask.filter(ImageFilter.GaussianBlur(radius=margin // 2))
        wall = Image.composite(
            wall, Image.new("RGB", (w, h), COLOR_BLACK), mask,
        )

    if noise:
        small = Image.effect_noise(
            (max(1, w // 4), max(1, h // 4)), _NOISE_SCALE,
        )
        grown = small.resize((w, h), Image.Resampling.BILINEAR).filter(
            ImageFilter.GaussianBlur(radius=_NOISE_BLUR_RADIUS),
        )
        wall = Image.blend(
            wall, ImageOps.colorize(grown, (0, 0, 0), color), 0.05,
        )

    return wall


def add_frame_texture(
    frame_img: Image.Image,
    strength: int = 18,
) -> Image.Image:
    """Blend horizontal wood-streak noise into the frame bands."""
    from PIL import Image, ImageFilter, ImageOps  # noqa: PLC0415

    if strength <= 0:
        return frame_img

    alpha = frame_img.getchannel("A") if frame_img.mode == "RGBA" else None
    base_rgb = frame_img.convert("RGB")

    w, h = base_rgb.size
    streaks = Image.effect_noise((max(1, w // 3), 1), 25.0).resize(
        (w, h), Image.Resampling.BILINEAR,
    ).filter(ImageFilter.GaussianBlur(radius=1))
    streaks_rgb = ImageOps.colorize(streaks, COLOR_BLACK, COLOR_WHITE)

    amount = min(_TEXTURE_BLEND_CAP, max(0.0, strength) / 100.0)
    blended = Image.blend(base_rgb, streaks_rgb, amount)

    if alpha is not None:
        out = blended.convert("RGBA")
        out.putalpha(alpha)
        return out
    return blended
