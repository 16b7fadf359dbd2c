"""Host time per call of the Gram kernel's wrapper, on the card.

    python -m style_transfer_visualizer_tpu_torch.tools.wrapper_host_time

For each Gram shape of the 512x512 main path, the host clock around
``reps`` back-to-back calls of ``ops.gram.gram_kernel`` (no
synchronisation inside the loop, so it measures what the host spends to
check, allocate and launch, while the card runs behind), then the
device time of the same calls from CUDA events. Runs in whatever tree
is first on ``sys.path``, so an older checkout can be measured the same
way. Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from style_transfer_visualizer_tpu_torch.ops import gram

SHAPES = [
    (262144, 64), (65536, 128), (16384, 256), (4096, 512), (1024, 512),
]


def main(reps: int = 200) -> int:
    """Print the card, then host and device us per call for each shape."""
    if not torch.cuda.is_available():
        msg = "wrapper_host_time needs a CUDA device"
        raise SystemExit(msg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sys.stdout.write(f"card: {card}\n")
    for p, c in SHAPES:
        f = torch.randn((p, c), device="cuda")
        for _ in range(5):
            gram.gram_kernel(f, 5e5, float(p * c))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            gram.gram_kernel(f, 5e5, float(p * c))
        host_us = (time.perf_counter() - t0) / reps * 1e6
        end.record()
        torch.cuda.synchronize()
        dev_us = start.elapsed_time(end) / reps * 1e3
        sys.stdout.write(
            f"gram ({p},{c}): host_us_per_call {host_us:.1f} "
            f"events_us_per_call {dev_us:.1f}\n",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
