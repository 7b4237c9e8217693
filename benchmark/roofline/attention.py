"""Work of one attention site: softmax(q k^T / sqrt(d)) v over n = batch x
heads rows of T queries and S keys of head dim d, bf16 operands.

Forward: 4 n T S d operations (two products); reads q, k, v and writes o
and the row statistics (float32). Backward, where the input's gradient is
wanted (the classifier under guidance): 10 n T S d, the five products a
fused backward needs (the scores, dP, dV, dK, dQ; the port's separate dQ
and dK/dV kernels recompute two of them, 14 n T S d, which is not counted:
the work is the operation's, not an implementation's); reads q, k, v, dO
and the row statistics, writes dq, dk, dv. Each input read once and each
output written once.
"""

ES = 2  # bf16


def work(site: dict):
    """[(operations, bytes, "bf16")] of the site, forward and backward."""
    n, t, s, d = site["n"], site["t"], site["s"], site["d"]
    out = [(4 * n * t * s * d,
            (2 * n * t * d + 2 * n * s * d) * ES + 4 * n * t, "bf16")]
    if site["grad"]:
        out.append((10 * n * t * s * d,
                    (3 * n * t * d + 2 * n * s * d) * ES + 8 * n * t
                    + (2 * n * s * d) * ES, "bf16"))
    return out
