"""``rank_peak_bytes``: the most device memory the run held allocated
on its fullest card, set-up and the window included
(``torch.cuda.max_memory_allocated`` of each rank, taken by the
harness): what a card must hold to run the cell. Nothing to read off
the card."""


def read(view):
    peak = max(view.peaks, default=0)
    return peak if peak > 0 else None
