"""The median request outside the traced stretch, ms by the host's clock,
in the sample cell (moves request_ms_p90)."""

import statistics


def read(r):
    ms = r.get("request_ms")
    return statistics.median(ms) if ms else None
