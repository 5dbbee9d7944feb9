"""Seconds from the harness's start (before torch is imported) to the first
timed request: weights, image pool, kernel builds where a cache misses, and
the warm-up that captures the fused program's graphs."""


def read(record):
    return record["setup_s"]
