"""``setup_s``: process start to the window's start, on the host's clock.

Import, the card check, the kernels loaded (built on a checkout's first
run), the weights made on the device, one warm-up image through the
window's entry and, on a mesh, the spawned ranks and their groups. On
a mesh it is world rank 0's, from the launching process's start.
"""


def read(view) -> float:
    return view.setup_s
