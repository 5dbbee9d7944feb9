"""Images completed over the window's seconds (host clock), the window
running from the first request's hand-over to the last one's logits."""


def read(record):
    return record["completed"] / record["window_s"] if record.get("window_s") else None
