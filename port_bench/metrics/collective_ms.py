"""``collective_ms``: device milliseconds a step in NCCL kernels over
the traced image, on the worst rank. Nothing to read where no rank
ran a collective."""
COLLECTIVES = ("nccl",)


def read(view):
    worst = None
    for entry in view.ranks:
        seen, seconds = view.kernel_time(entry, COLLECTIVES)
        if seen:
            ms = seconds * 1e3 / view.traced_steps
            worst = ms if worst is None else max(worst, ms)
    return worst
