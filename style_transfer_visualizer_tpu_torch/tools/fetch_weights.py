"""Convert a torchvision VGG checkpoint already on disk into the cache.

    python -m style_transfer_visualizer_tpu_torch.tools.fetch_weights \\
        [--model vgg19|vgg16] [--checkpoint-dir DIR] [--cache-dir DIR] \\
        [--force]

The conversion half of the JAX package's ``stv-fetch-weights``, with
its flags, for a machine without JAX (the card's): it finds the
torchvision ``.pth`` of ``--model`` in ``--checkpoint-dir`` (torch
hub's layout, ``vgg19-dcbb9e9d.pth``), converts it with
``models.vgg19.convert_torch_state_dict`` and writes the flat ``.npz``
that both packages read. It downloads nothing (and has no ``--url``):
with no ``.pth`` there it exits 1 and says where to put one, fetched on
a machine with network access.
"""
from __future__ import annotations

import argparse
import sys
from collections.abc import Sequence
from pathlib import Path

from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.utils.logging import logger


def main(argv: Sequence[str] | None = None) -> int:
    """Convert the ``.pth`` into the ``.npz`` cache.

    Returns 0 when the cache holds the converted weights, 1 when no
    ``.pth`` of the model is in ``--checkpoint-dir``.
    """
    parser = argparse.ArgumentParser(
        prog="stv-fetch-weights-torch",
        description=(
            "Convert a torchvision VGG checkpoint already on disk into "
            "the .npz weight cache (no download)."
        ),
    )
    parser.add_argument(
        "--model", choices=["vgg19", "vgg16"], default="vgg19",
        help="Which backbone's weights to convert (default: vgg19)",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=str(Path.home() / ".cache" / "torch" / "hub" / "checkpoints"),
        help="Where the .pth checkpoint is (torch hub layout)",
    )
    parser.add_argument(
        "--cache-dir", default=None,
        help="Converted .npz destination dir (default: the runtime cache)",
    )
    parser.add_argument(
        "--force", action="store_true",
        help="Convert again even when the .npz exists",
    )
    args = parser.parse_args(argv)

    arch = get_architecture(args.model)
    cache_dir = (
        Path(args.cache_dir) if args.cache_dir else vgg19.default_cache_dir()
    )
    cache_path = cache_dir / arch.cache_filename
    if cache_path.exists() and not args.force:
        logger.info("Converted weights already cached at %s", cache_path)
        return 0
    checkpoint_dir = Path(args.checkpoint_dir)
    found = sorted(
        hit
        for pattern in arch.checkpoint_globs
        for hit in checkpoint_dir.glob(pattern)
    )
    if not found:
        logger.error(
            "No %s checkpoint (%s) in %s. This tool downloads nothing: "
            "fetch the torchvision checkpoint on a machine with network "
            "access (the JAX package's stv-fetch-weights, or torchvision) "
            "and copy it into %s, or copy a converted %s over.",
            arch.name, " or ".join(arch.checkpoint_globs), checkpoint_dir,
            checkpoint_dir, cache_path,
        )
        return 1
    logger.info("Converting %s -> %s", found[0], cache_path)
    vgg19.save_params_npz(
        vgg19._convert_checkpoint(found[0], arch),  # noqa: SLF001
        cache_path,
    )
    logger.info(
        "Converted weights cached at %s. Runs no longer need "
        "--allow-random-weights.", cache_path,
    )
    return 0


def entrypoint() -> None:
    """Console-script entry."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
