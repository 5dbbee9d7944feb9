"""CUDA-graph replays of the fused engine per traced image: the delta of
``DynamicInferenceEngine.replays`` over the traced images (a decision and
its exit head, or every decision and the final segment)."""


def read(record):
    n, replays = len(record.get("traced_exits") or ()), record.get("traced_replays")
    return replays / n if n and replays is not None else None
