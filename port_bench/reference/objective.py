"""VGG features, Gram matrices and the Gatys objective in plain PyTorch.

Layout NCHW, ``torch.nn.functional`` convolutions and pooling in fp32.
A tap at layer ``i`` is the activation after layer ``i`` runs, so a
conv tap is the conv's output before its ReLU. A Gram is ``F^T F``
over the pixels of one image, each entry clamped from above at the
configuration's ``gram_clamp`` and then divided by ``H * W * C``; a
style term is the mean squared difference of the image's Gram and the
style's, a content term the mean squared difference of the features.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F  # noqa: N812

CONV, RELU, POOL = "conv", "relu", "pool"


def layer_table(cfg: list) -> list[tuple[str, int, int]]:
    """``(kind, C_in, C_out)`` per layer index of a VGG feature config
    (torchvision's numbering: a ReLU follows each conv, ``"M"`` pools)."""
    rows: list[tuple[str, int, int]] = []
    c_in = 3
    for item in cfg:
        if item == "M":
            rows.append((POOL, c_in, c_in))
        else:
            rows.append((CONV, c_in, int(item)))
            rows.append((RELU, int(item), int(item)))
            c_in = int(item)
    return rows


def normalize(image: torch.Tensor, config: dict) -> torch.Tensor:
    """(1, H, W, 3) in [0, 1] to the model's NCHW input."""
    mean = torch.tensor(config["image_mean"], device=image.device)
    std = torch.tensor(config["image_std"], device=image.device)
    return ((image - mean) / std).permute(0, 3, 1, 2)


def features(
    weights: dict[int, tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    taps: tuple[int, ...],
    table: list[tuple[str, int, int]],
) -> dict[int, torch.Tensor]:
    """The activations at ``taps`` of an NCHW batch; layers past the
    deepest tap do not run. ``weights[i]`` is layer ``i``'s OIHW kernel
    and bias."""
    acts: dict[int, torch.Tensor] = {}
    for idx in range(max(taps) + 1):
        kind = table[idx][0]
        if kind == CONV:
            w, b = weights[idx]
            x = F.conv2d(x, w, b, padding=1)
        elif kind == RELU:
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, 2)
        if idx in taps:
            acts[idx] = x
    return acts


def gram(act: torch.Tensor, clamp: float) -> torch.Tensor:
    """The clamped, normalized Gram of each image of an NCHW batch."""
    n, c, h, w = act.shape
    flat = act.reshape(n, c, h * w)
    raw = flat @ flat.transpose(1, 2)
    return torch.clamp(raw, max=clamp) / (h * w * c)


class Objective:
    """The loss of one image against one style's and one content's
    targets: ``(total, style score, content score)``."""

    def __init__(
        self,
        config: dict,
        weights: dict[int, tuple[torch.Tensor, torch.Tensor]],
        content: torch.Tensor,
        style: torch.Tensor,
    ) -> None:
        self.config = config
        self.weights = weights
        self.table = layer_table(config["cfg"])
        self.style_layers = tuple(config["style_layers"])
        self.content_layers = tuple(config["content_layers"])
        self.clamp = float(config["gram_clamp"])
        with torch.no_grad():
            style_acts = features(
                weights, normalize(style, config), self.style_layers,
                self.table,
            )
            self.grams = {
                i: gram(a, self.clamp) for i, a in style_acts.items()
            }
            self.content_feats = features(
                weights, normalize(content, config), self.content_layers,
                self.table,
            )

    def __call__(self, x: torch.Tensor):
        """``x`` is the (1, H, W, 3) image in the model's normalized
        space, as the optimizer holds it."""
        taps = tuple(sorted({*self.style_layers, *self.content_layers}))
        acts = features(self.weights, x.permute(0, 3, 1, 2), taps, self.table)
        style = sum(
            torch.mean(torch.square(gram(acts[i], self.clamp) - self.grams[i]))
            for i in self.style_layers
        )
        content = sum(
            torch.mean(torch.square(acts[i] - self.content_feats[i]))
            for i in self.content_layers
        )
        total = (
            self.config["style_w"] * style + self.config["content_w"] * content
        )
        return total, style, content
