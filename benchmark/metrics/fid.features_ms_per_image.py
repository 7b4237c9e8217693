"""Device ms inside the ``bench.features`` ranges an image, in the search
cells (moves images_per_s)."""


def read(r):
    n = r.get("features", {}).get("images", 0)
    if not n:
        return None
    return r["range_device_s"]["bench.features"] * 1e3 / n
