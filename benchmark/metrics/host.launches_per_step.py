"""The port's kernel launches (ops.LAUNCHES) a sampler step, in the search
cells (moves images_per_s)."""


def read(r):
    if not r.get("steps"):
        return None
    return r["launches"] / r["steps"]
