"""Constants the port shares across its modules.

The values equal those of the JAX package's ``constants.py`` so both
packages normalize, clamp and validate alike; the port keeps its own
copy instead of importing that package.
"""
from __future__ import annotations

# --- Normalization (torchvision ImageNet statistics) ---------------------
IMAGENET_MEAN: tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: tuple[float, float, float] = (0.229, 0.224, 0.225)

# --- Numerical stability --------------------------------------------------
# Per-element ceiling applied to the raw (un-normalized) Gram matrix before
# dividing by the element count; keeps style gradients from exploding.
GRAM_MATRIX_CLAMP_MAX = 5e5

# --- Memory policy ----------------------------------------------------
# Pixel counts from which the JAX package evaluates the loss in row
# bands (ops/tiled.py) and rematerializes features. The port has
# neither yet (ROADMAP queue 6): its coarse warm start refuses a level
# this large rather than run it whole.
AUTO_TILE_PIXEL_THRESHOLD = 4_200_000
AUTO_REMAT_PIXEL_THRESHOLD = 2048 * 2048

# --- Image size limits ------------------------------------------------
MIN_DIMENSION = 64       # hard error below this
MAX_DIMENSION = 3000     # soft warning above this

# --- Video encoding ---------------------------------------------------
VIDEO_CODEC = "libx264"
ENCODING_BLOCK_SIZE = 16         # output dims padded to this macroblock size
VIDEO_QUALITY_MIN = 1
VIDEO_QUALITY_MAX = 10

# --- Palette ----------------------------------------------------------
COLOR_MODE_RGB = "RGB"
COLOR_BLACK = (0, 0, 0)
COLOR_WHITE = (255, 255, 255)
COLOR_BEIGE = (240, 236, 226)
COLOR_GREY = (60, 67, 74)

# --- Loss logging -----------------------------------------------------
CSV_LOGGING_RECOMMENDED_STEPS = 2000

# --- Canvas -----------------------------------------------------------
RESOLUTION_FULL_HD = (1920, 1080)
