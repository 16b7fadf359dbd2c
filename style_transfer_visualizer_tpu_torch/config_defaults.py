"""User-facing configuration defaults of the port.

The values equal the JAX package's ``config_defaults.py`` for every
field the port reads, except the device, which is ``cuda`` here.
"""
from __future__ import annotations

from style_transfer_visualizer_tpu_torch.type_defs import (
    ColorPreservation,
    DirectionName,
    HistoryDtypeName,
    InitMethod,
    ModelName,
    OptimizerName,
    PrecisionName,
    VideoMode,
)

# --- Output ---------------------------------------------------------------
DEFAULT_OUTPUT_DIR = "out"
# Host-sync cadence for loss scalars (and CSV row cadence).
DEFAULT_LOG_EVERY = 10

# --- Hardware ---------------------------------------------------------
DEFAULT_DEVICE = "cuda"
# "mixed" runs the first two VGG blocks' forward convs and every Gram's
# forward in IEEE fp32 and the rest in 3xTF32 (ops/precision.py's
# MIXED, the JAX package's policy); "highest" is IEEE fp32 throughout,
# "high" 3xTF32, "default" TF32.
DEFAULT_PRECISION: PrecisionName = "mixed"

# --- Optimization -----------------------------------------------------
DEFAULT_STEPS = 1500
DEFAULT_LEARNING_RATE = 1.0
DEFAULT_STYLE_WEIGHT = 1e5
DEFAULT_CONTENT_WEIGHT = 1.0
# Total-variation weight (0 = the style + content loss alone).
DEFAULT_TV_WEIGHT = 0.0
# Laplacian detail-preservation weight and its pooling size (Lapstyle,
# Li et al. 2017 arXiv:1707.01253; 0 = the style + content loss alone).
DEFAULT_LAP_WEIGHT = 0.0
DEFAULT_LAP_POOL = 4
# Color preservation ("off": the output inherits the style's palette).
DEFAULT_PRESERVE_COLOR: ColorPreservation = "off"
DEFAULT_SEED = 0
DEFAULT_INIT_METHOD: InitMethod = "random"
DEFAULT_NORMALIZE = True
# One function evaluation per accepted step.
DEFAULT_LBFGS_MAX_ITER = 1
DEFAULT_LBFGS_MAX_EVAL = 1
# Indices into the VGG19 feature stack (torchvision layer numbering):
# conv1_1, conv2_1, conv3_1, conv4_1, conv5_1 for style; conv4_2 for
# content.
DEFAULT_STYLE_LAYERS: tuple[int, ...] = (0, 5, 10, 19, 28)
DEFAULT_CONTENT_LAYERS: tuple[int, ...] = (21,)
# Feature backbone. With another model and the layer lists left at the
# VGG19 defaults above, config validation remaps them to that model's
# own standard taps (models/arch.py).
DEFAULT_MODEL: ModelName = "vgg19"
DEFAULT_OPTIMIZER: OptimizerName = "lbfgs"
# Coarse-to-fine warm start: -1 is auto (on for content of at least
# 1 MP, with a budget of steps // 5), 0 off, N > 0 that many steps.
DEFAULT_COARSE_STEPS = -1
DEFAULT_PYRAMID_LEVELS = 2
DEFAULT_LBFGS_HISTORY_SIZE = 100
DEFAULT_LBFGS_HISTORY_DTYPE: HistoryDtypeName = "bfloat16"
DEFAULT_LBFGS_DIRECTION: DirectionName = "compact"

# --- Video ------------------------------------------------------------
DEFAULT_CREATE_VIDEO = True
DEFAULT_VIDEO_MODE: VideoMode = "realtime"
DEFAULT_SAVE_EVERY = 20
DEFAULT_FPS = 10
DEFAULT_VIDEO_QUALITY = 10
DEFAULT_FINAL_ONLY = False
DEFAULT_VIDEO_INTRO_ENABLED = True
DEFAULT_VIDEO_INTRO_DURATION = 10.0
DEFAULT_VIDEO_OUTRO_DURATION = 10.0
DEFAULT_VIDEO_FINAL_FRAME_COMPARE = True
DEFAULT_CREATE_GIF = False
DEFAULT_GIF_INCLUDE_INTRO = False
DEFAULT_GIF_INCLUDE_OUTRO = False
