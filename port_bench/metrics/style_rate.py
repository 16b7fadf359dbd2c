"""``style_rate``: styles x steps over the wall time of a traced run's
untraced images, from the entry of the first of them to the end of the
last, their set-up and final images included: ``style_steps_per_s``
read per layer, without the image the profiler slows. Nothing to read
where the window held no untraced image."""


def read(view):
    records = view.records[1:] if view.ranks else view.records
    if not records:
        return None
    done = sum(r["steps"] * r["styles"] for r in records)
    return done / (records[-1]["t_end"] - records[0]["t_entry"])
