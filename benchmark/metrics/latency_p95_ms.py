"""95th percentile of request latency over every request the window
completed (host clock; linear interpolation between order statistics)."""
import numpy as np


def read(record):
    lat = record.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
