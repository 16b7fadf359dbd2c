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

# --- Memory: banded evaluation and remat (H100 values) -----------------
# Measured by tools/memory_peaks.py on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (torch.cuda.mem_get_info total 85,017,493,504 B):
# graphed runs at the shipped defaults (mixed, L-BFGS m = 100 in bf16,
# compact direction). A whole-image run's allocated peak is
# 558,789,632 + 2,866 B a pixel (2048x2048: 12,579,664,896; 3840x2160:
# 24,338,109,440; 4096x4096: 48,642,290,688; 4864x4864: 68,365,087,744)
# and its reserved peak 1.20-1.27 times that; 5120x5120 runs out of
# memory. Of a pixel's 2,866 B, the ring holds 1,200 and the step's
# activations about 1,600. These were measured while the direction still
# upcast the bf16 ring to fp32 in blocks of ops/lbfgs_ring.UPCAST_COLUMNS
# columns (up to 3.4 GB at m = 100); on the card it now runs as two
# kernels over the bf16 ring (50-201 MB above it up to 4096x4096), so the
# thresholds below may switch to bands and remat earlier than memory
# requires, by up to that block. Not yet measured again.

# Content of at least this many pixels is evaluated in bands: 21 MP
# predicts 60.7 GB allocated, 77.1 GB reserved at 1.27x (91% of the
# card); 4608x4608 (21.2 MP) ran with 78,032,928,768 B reserved, 92%.
AUTO_TILE_PIXEL_THRESHOLD = 21_000_000

# Remat cuts the peak by 8% (2,636 B a pixel), but it ran no size the
# whole run could not: 4864x4864 ran both ways (remat 62,918,964,224 B
# allocated), 5120x5120 neither. So it turns itself on only from the
# band threshold, for a height that admits no exact band tiling.
AUTO_REMAT_PIXEL_THRESHOLD = AUTO_TILE_PIXEL_THRESHOLD

# The batch has no bands; its peaks grow by pixels x styles as the
# single run's do (S = 4, 8 at 512x512 and S = 16 at 1024x1024: 2,832 B
# a pixel-style whole, 2,598 with remat; 16 x 1024x1024 48,103,296,512
# B whole, 44,170,612,224 rematerialized), so remat, its one lever,
# turns on where the single run would band.
BATCH_AUTO_REMAT_PIXEL_THRESHOLD = AUTO_TILE_PIXEL_THRESHOLD

# Largest band window (band plus margins) auto_tile_rows picks. A band
# holds the step's activations for its window, about 1,640 B a pixel,
# beside the whole image's ring and targets: 7680x4320 (8K UHD) holds
# 42,954,661,376 B before its steps; in 5 bands of 864 rows (windows of
# 7.86 MP) it peaks at 55,888,999,936 B allocated, 63,810,043,904 B
# reserved (75%); in 3 of 1440 (12.3 MP) at 76,657,197,056 B reserved
# (90%); in 2 of 2160 it runs out of memory.
MAX_BAND_PIXELS = 8_000_000

# --- Row-sharded evaluation (parallel/mesh.py, parallel/spatial.py) ----
# The mesh's two logical axes, named as in the JAX package: ``style``
# (independent style targets) and ``space`` (image rows).
MESH_AXIS_STYLE = "style"
MESH_AXIS_SPACE = "space"

# Seconds a rank waits at the rendezvous or in one collective before it
# raises: a rank that died or took another branch fails the run instead
# of hanging it. Rank 0 makes the starting image alone (the warm start
# included) while the others wait in its broadcast, so the bound is
# generous.
SPATIAL_TIMEOUT_SECONDS = 1800.0
