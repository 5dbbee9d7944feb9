"""Median request latency over every request the window completed (host
clock: the host image handed over to the exit's logits ready on the device)."""
import numpy as np


def read(record):
    lat = record.get("latencies_s")
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
