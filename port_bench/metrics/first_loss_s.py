"""``first_loss_s``: for each image of the window, the seconds from the
entry call to the first loss value on the host, the first sign of
progress a user sees; the mean over the window's images, leaving out
the traced one (the profiler slows it).

It covers the per-image set-up: the inputs, the targets, the starting
image, the warm-up step and the capture, and the first dispatch. It is
a per-layer reading of the entry: the per-image capture empties the
allocator's caches, and the stalls that follow on some images spread
it by 6-26% from run to run, too wide for any bound an end-to-end
metric may take.
"""


def read(view):
    records = view.records[1:] if view.ranks else view.records
    if not records:
        return None
    waits = [r["t_first"] - r["t_entry"] for r in records]
    return sum(waits) / len(waits)
