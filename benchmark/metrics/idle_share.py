"""% of the traced window with no operation on the device, in the search
cells (moves images_per_s). There the device is busy all through a
fitness call, so the profiler's cost to the host does not show (the
sample cell reads idle_share.request instead)."""


def read(r):
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
