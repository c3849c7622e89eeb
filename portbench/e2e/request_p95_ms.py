"""request_p95_ms: the 95th percentile (numpy's linear interpolation) over
every request of the window of the host-clock time from the server's call
until its numpy outputs are returned."""
import numpy as np


def read(ctx):
    lat = ctx.records.get("request_latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
