"""Inputs made from the run's seed: weights, images and their seeds.

The one generator every traffic mix goes through. A mix
(``port_bench/traffic/<name>.json``) gives the sizes; every image of a
run, the set-up's warm-up image included, has those same sizes, and
the seed changes only what is drawn. Image ``index`` of a run with
seed ``seed`` draws from ``SeedSequence([seed, index])``: its content
and styles from the first number, the optimizer's starting image from
the second (the port's ``optimization.seed``). The weights draw from
``SeedSequence([seed])``, on the device, in one call, as the
configuration's family (``port_bench/families``) lays them out.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812

from port_bench import families

#: Keep seeds to 63 bits: ``torch.Generator.manual_seed`` takes them,
#: and so does the port's ``optimization.seed``.
_SEED_MASK = (1 << 63) - 1
#: The warm-up image's index: no image of a window has it.
WARMUP_INDEX = 1 << 20


def image_seeds(seed: int, index: int) -> tuple[int, int]:
    """``(images, start)``: the seeds of image ``index``."""
    words = np.random.SeedSequence([seed, index]).generate_state(2, np.uint64)
    return int(words[0]) & _SEED_MASK, int(words[1]) & _SEED_MASK


def weights_seed(seed: int) -> int:
    words = np.random.SeedSequence([seed]).generate_state(1, np.uint64)
    return int(words[0]) & _SEED_MASK


def make_weights(config: dict, seed: int, device: torch.device) -> dict:
    """The weights of ``config``'s architecture, drawn on ``device`` by
    its family's ``make_weights``."""
    return families.load(config).make_weights(config, seed, device)


def _field(gen, device, height: int, width: int, cells: int, noise: float):
    low = torch.rand(
        (1, 3, height // cells + 2, width // cells + 2),
        generator=gen, device=device,
    )
    img = F.interpolate(low, size=(height, width), mode="bicubic")
    img = img + noise * torch.randn(
        (1, 3, height, width), generator=gen, device=device,
    )
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def make_images(
    traffic: dict, seed: int, index: int, device: torch.device,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Image ``index``'s content and styles: (1, H, W, 3) float32 host
    arrays in [0, 1], as a decoder hands them over. Smooth colour fields
    with fine noise: the content's features vary slowly, the styles'
    cells are the mix's ``style_cells`` pixels across."""
    images_seed, _ = image_seeds(seed, index)
    gen = torch.Generator(device=device).manual_seed(images_seed)
    look = traffic["image"]
    content = _field(
        gen, device, *traffic["content"], look["content_cells"], look["noise"],
    )
    styles = [
        _field(gen, device, h, w, look["style_cells"], look["noise"])
        for h, w in traffic["styles"]
    ]
    return (
        content.cpu().numpy(),
        [s.cpu().numpy() for s in styles],
    )
