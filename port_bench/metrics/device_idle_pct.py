"""``device_idle_pct``: the share of the traced span in which the card
runs nothing (the span less the union of its kernels', copies' and
sets' intervals); on a mesh the worst rank's."""


def read(view):
    worst = None
    for entry in view.ranks:
        summary = entry["summary"]
        if not summary["kernels"]:
            return None
        idle = 100.0 * (1.0 - summary["busy_s"] / summary["span_s"])
        worst = idle if worst is None else max(worst, idle)
    return worst
