"""`groupnorm_roofline` in the sample cell, which reports request_ms_p90 and not
images_per_s."""

from benchmark.harness.spec import reader

read = reader("groupnorm_roofline").read
