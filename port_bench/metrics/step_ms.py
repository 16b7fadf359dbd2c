"""``step_ms``: the window's wall time over the full-size optimizer
steps it completed.

Every image's set-up (inputs, targets, the starting image, the
capture), its frames and loss reads and its final image on the host
fall inside the window, so they are in the mean.
"""


def read(view) -> float:
    steps = sum(r["steps"] for r in view.records)
    return view.window_s * 1e3 / steps
