"""Work of one GroupNorm site (with its FiLM and SiLU, as the program's
norm applies them in one pass): an [n, c, hw] bf16 tensor in groups.

Forward: about 12 float32 operations an element; reads x, writes y, plus
the affine parameters, the FiLM scale and shift [n, c] where there are
any, and the [n, groups] mean and inverse deviation. Backward, where the
input's gradient is wanted: about 20 operations an element; reads x and
dy, writes dx (the gradient the guidance asks for, no parameter's).
"""

ES = 2  # bf16


def work(site: dict):
    """[(operations, bytes, "fp32")] of the site, forward and backward."""
    n, c, hw, g = site["n"], site["c"], site["hw"], site["groups"]
    elems = n * c * hw
    small = 2 * c * 4 + 2 * n * g * 4 + (2 * n * c * 4 if site["film"]
                                         else 0)
    out = [(12 * elems, 2 * elems * ES + small, "fp32")]
    if site["grad"]:
        out.append((20 * elems, 3 * elems * ES + small, "fp32"))
    return out
