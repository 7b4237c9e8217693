"""Device ms inside the ``bench.unet`` ranges / (images x calls), in the
search cells (moves images_per_s)."""


def read(r):
    n = r.get("unet", {}).get("images", 0)
    if not n:
        return None
    return r["range_device_s"]["bench.unet"] * 1e3 / n
