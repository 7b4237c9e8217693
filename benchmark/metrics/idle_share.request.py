"""% of a request with no operation on the device, in the sample cell
(moves request_ms_p90): 1 - (device busy time a traced request) / (the
median untraced request's wall time, host clock). The profiler slows the
host's dispatch, so the traced stretch's own wall time (idle_share's
denominator) would read the profiler, not the request; the device's busy
time a request it records is the untraced run's."""

import statistics


def read(r):
    ms = r.get("request_ms")
    if not ms or not r["units"]["traced"]:
        return None
    busy = r["busy_s"] / r["units"]["traced"]
    return 100.0 * (1.0 - busy / (statistics.median(ms) / 1e3))
