"""``style_steps_per_s``: styles x steps completed over the window's
wall time, every batch's set-up and final images included."""


def read(view) -> float:
    done = sum(r["steps"] * r["styles"] for r in view.records)
    return done / view.window_s
