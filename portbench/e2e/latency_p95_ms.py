"""latency_p95_ms: the 95th percentile (numpy's linear interpolation) over
every call of the window of the host-clock time from the call's start
until its outputs are complete on the device."""
import numpy as np


def read(ctx):
    lat = ctx.records.get("call_latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
