"""`host.launches_per_step` in the sample cell, which reports request_ms_p90 and not
images_per_s."""

from benchmark.harness.spec import reader

read = reader("host.launches_per_step").read
