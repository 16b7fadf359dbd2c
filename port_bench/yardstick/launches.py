"""The hand-written kernels' launches that one image of a cell makes,
worked out from the cell's shapes as the port's code path runs them.

One image is its targets and its ``steps`` steps:

- targets: each style's sweep to the deepest style tap, at the style's
  own size, with one Gram per style tap; one content sweep to the
  deepest content tap (on a mesh, of this rank's rows);
- a step (one evaluation: L-BFGS with one iteration, or Adam): the
  forward sweep to the deepest tap over the image batch this rank
  holds, one input-gradient conv per forward conv (the image is the
  leaf, so conv 0's too), and one Gram launch per style tap for all
  the images it holds.

On a style x space mesh a rank holds ``S / n_style`` styles and
``1 / n_space`` of the rows at every scale. A conv there is counted at
the rows its output needs; it reads those rows and one halo row from
each neighbour. The rows it computes past them and crops are waste,
and show as such in a roofline.
"""
from __future__ import annotations

from dataclasses import dataclass

from port_bench.reference.objective import CONV, layer_table
from port_bench.yardstick.flops import pools_before_in


@dataclass(frozen=True)
class Conv:
    """One conv launch: ``n`` images of ``h`` x ``w`` output rows,
    ``rows_in`` input rows, ``c_in`` to ``c_out`` channels; a forward
    adds its bias, and an input-gradient conv of a conv fused with its
    ReLU reads that conv's output as the ReLU's mask."""

    n: int
    h: int
    w: int
    c_in: int
    c_out: int
    rows_in: int
    bias: bool
    mask: bool = False


@dataclass(frozen=True)
class Gram:
    """One Gram launch over ``images`` blocks of ``pixels`` x
    ``channels``."""

    images: int
    pixels: int
    channels: int


def _sweep(table, last: int, n: int, h: int, w: int, *, parts=1, halo=0,
           taps=None):
    """The forward convs to layer ``last``. Given the step's ``taps``,
    ``mask`` marks a conv fused with its ReLU (not a tap, and its ReLU
    runs), whose input-gradient conv reads the mask."""
    convs = []
    for idx, (kind, c_in, c_out) in enumerate(table[: last + 1]):
        if kind != CONV:
            continue
        scale = 2 ** pools_before_in(table, idx)
        rows = h // scale // parts
        fused = taps is not None and idx < last and idx not in taps
        convs.append(Conv(
            n, rows, w // scale, c_in, c_out, rows + halo, bias=True,
            mask=fused,
        ))
    return convs


def _grams(table, layers, images: int, h: int, w: int, parts=1):
    out = []
    for idx in layers:
        scale = 2 ** pools_before_in(table, idx)
        pixels = (h // scale // parts) * (w // scale)
        out.append(Gram(images, pixels, table[idx][2]))
    return out


def image_launches(
    config: dict, traffic: dict, rank: int = 0,
) -> tuple[list[Conv], list[Gram]]:
    """The conv and Gram launches of one image on world rank ``rank``
    (rank ``r = style_index * n_space + space_index``)."""
    table = layer_table(config["cfg"])
    style_layers = config["style_layers"]
    content_layers = config["content_layers"]
    last = max(*style_layers, *content_layers)
    height, width = traffic["content"]
    styles = traffic["styles"]
    mesh = traffic.get("mesh") or {"style": 1, "space": 1}
    n_style, n_space = mesh["style"], mesh["space"]
    style_index, space_index = divmod(rank, n_space)
    local = len(styles) // n_style
    mine = styles[style_index * local:(style_index + 1) * local]
    halo = (space_index > 0) + (space_index < n_space - 1)

    convs: list[Conv] = []
    grams: list[Gram] = []
    for sh, sw in mine:
        convs += _sweep(table, max(style_layers), 1, sh, sw)
        grams += _grams(table, style_layers, 1, sh, sw)
    convs += _sweep(
        table, max(content_layers), 1, height, width, parts=n_space,
        halo=halo,
    )
    forward = _sweep(
        table, last, local, height, width, parts=n_space, halo=halo,
        taps={*style_layers, *content_layers},
    )
    backward = [
        Conv(c.n, c.h, c.w, c.c_out, c.c_in, c.rows_in, bias=False, mask=c.mask)
        for c in forward
    ]
    forward = [
        Conv(c.n, c.h, c.w, c.c_in, c.c_out, c.rows_in, bias=True)
        for c in forward
    ]
    step_grams = _grams(table, style_layers, local, height, width, n_space)
    steps = traffic["steps"]
    return (
        convs + (forward + backward) * steps,
        grams + step_grams * steps,
    )
