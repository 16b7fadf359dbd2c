"""User-facing configuration defaults of the port.

The values equal the JAX package's ``config_defaults.py`` for every
field the port reads, except the device, which is ``cuda`` here.
"""
from __future__ import annotations

from style_transfer_visualizer_tpu_torch.type_defs import (
    DirectionName,
    HistoryDtypeName,
    InitMethod,
)

# --- Output ---------------------------------------------------------------
DEFAULT_OUTPUT_DIR = "out"
# Host-sync cadence for loss scalars.
DEFAULT_LOG_EVERY = 10

# --- Hardware ---------------------------------------------------------
DEFAULT_DEVICE = "cuda"

# --- Optimization -----------------------------------------------------
DEFAULT_STEPS = 1500
DEFAULT_LEARNING_RATE = 1.0
DEFAULT_STYLE_WEIGHT = 1e5
DEFAULT_CONTENT_WEIGHT = 1.0
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
DEFAULT_LBFGS_HISTORY_SIZE = 100
DEFAULT_LBFGS_HISTORY_DTYPE: HistoryDtypeName = "bfloat16"
DEFAULT_LBFGS_DIRECTION: DirectionName = "compact"
