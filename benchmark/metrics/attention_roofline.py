"""% of the attention roofline (roofline/count.py::share), in the search
cells (moves images_per_s)."""

from benchmark.roofline.count import share


def read(r):
    return share(r, "attention")
