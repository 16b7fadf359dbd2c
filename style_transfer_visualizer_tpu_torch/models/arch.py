"""VGG layer tables with torchvision-compatible numbering.

The port's own copy of the JAX package's ``models/arch.py`` registry:
VGG19 and VGG16. An :class:`Architecture` carries the conv/relu/pool
layer table (indices match ``torchvision.models.<name>().features``)
and the literature-standard style/content taps. Code that has
parameters in hand derives the table from them
(:func:`layer_table_from_params`); code that runs before the weights
exist looks the model up by name (:func:`get_architecture`).
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field

CONV = "conv"
RELU = "relu"
POOL = "pool"

#: (kind, in_channels, out_channels) per torchvision feature index.
LayerTable = tuple[tuple[str, int, int], ...]


def _expand_cfg(cfg: tuple[int | str, ...]) -> LayerTable:
    """Expand a VGG config string into one (kind, in, out) row per index."""
    rows: list[tuple[str, int, int]] = []
    in_ch = 3
    for item in cfg:
        if item == "M":
            rows.append((POOL, in_ch, in_ch))
        else:
            out_ch = int(item)
            rows.append((CONV, in_ch, out_ch))
            rows.append((RELU, out_ch, out_ch))
            in_ch = out_ch
    return tuple(rows)


@dataclass(frozen=True)
class Architecture:
    """A VGG-family feature stack with torchvision-compatible numbering."""

    name: str
    cfg: tuple[int | str, ...]
    #: conv1_1..conv5_1 (pre-ReLU) for style, conv4_2 for content.
    default_style_layers: tuple[int, ...]
    default_content_layers: tuple[int, ...]
    #: Converted-weights archive name (the JAX package's cache name).
    cache_filename: str
    #: Torchvision checkpoint file name globs to convert from.
    checkpoint_globs: tuple[str, ...]
    layer_table: LayerTable = field(init=False)
    conv_indices: tuple[int, ...] = field(init=False)

    def __post_init__(self) -> None:
        table = _expand_cfg(self.cfg)
        object.__setattr__(self, "layer_table", table)
        object.__setattr__(
            self,
            "conv_indices",
            tuple(i for i, (k, _, _) in enumerate(table) if k == CONV),
        )


def pools_before_in(table: LayerTable, idx: int) -> int:
    """Pools crossed at or before ``idx`` in a layer table.

    Spatial dims at a tap are the input dims divided by
    ``2**pools_before_in(table, idx)``.
    """
    return sum(
        1 for j, (kind, _, _) in enumerate(table) if j <= idx and kind == POOL
    )


def layer_table_from_params(params: Mapping[int, Mapping]) -> LayerTable:
    """Reconstruct the layer table from a params dict's structure.

    Conv indices are the dict keys and channel widths come from the
    ``(9, C_in, C_out)`` stencil shapes; relu/pool positions follow from
    the VGG grammar (a relu follows every conv, anything else is a
    pool, and the stack ends conv, relu, pool).
    """
    if not params:
        msg = "Cannot derive a layer table from empty params"
        raise ValueError(msg)
    convs = sorted(params)
    rows: list[tuple[str, int, int]] = []
    for idx in range(convs[-1] + 3):
        if idx in params:
            w9 = params[idx]["w9"]
            rows.append((CONV, int(w9.shape[1]), int(w9.shape[2])))
        elif idx - 1 in params:
            ch = int(params[idx - 1]["w9"].shape[2])
            rows.append((RELU, ch, ch))
        else:
            ch = rows[-1][2] if rows else 3
            rows.append((POOL, ch, ch))
    return tuple(rows)


VGG19 = Architecture(
    name="vgg19",
    cfg=(
        64, 64, "M",
        128, 128, "M",
        256, 256, 256, 256, "M",
        512, 512, 512, 512, "M",
        512, 512, 512, 512, "M",
    ),
    default_style_layers=(0, 5, 10, 19, 28),
    default_content_layers=(21,),
    cache_filename="vgg19_imagenet.npz",
    checkpoint_globs=("vgg19-*.pth", "vgg19.pth"),
)

VGG16 = Architecture(
    name="vgg16",
    cfg=(
        64, 64, "M",
        128, 128, "M",
        256, 256, 256, "M",
        512, 512, 512, "M",
        512, 512, 512, "M",
    ),
    # The same named taps on VGG16's flat numbering: conv1_1=0,
    # conv2_1=5, conv3_1=10, conv4_1=17, conv5_1=24; content conv4_2=19.
    default_style_layers=(0, 5, 10, 17, 24),
    default_content_layers=(19,),
    cache_filename="vgg16_imagenet.npz",
    checkpoint_globs=("vgg16-*.pth", "vgg16.pth"),
)

ARCHITECTURES: dict[str, Architecture] = {a.name: a for a in (VGG19, VGG16)}


def get_architecture(name: str) -> Architecture:
    """Look up an architecture by name with a helpful error."""
    try:
        return ARCHITECTURES[name]
    except KeyError:
        known = ", ".join(sorted(ARCHITECTURES))
        msg = f"Unknown model architecture {name!r}; known: {known}"
        raise ValueError(msg) from None
