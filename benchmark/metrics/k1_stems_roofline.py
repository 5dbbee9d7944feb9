"""K1's share of its roofline (%): the least time the traced images' stems
could take (``counts.stems.bound_s``, one call an image, published peaks)
over the device time of K1's kernel (``stems_kernel``) in the trace."""
from benchmark.counts import stems


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    times = [b - a for name, a, b in tr["device"] if "stems_kernel" in name]
    if not times:
        return None
    h, w = record["image_hw"]
    return 100.0 * len(record["traced_exits"]) * stems.bound_s(h, w, record["cell"]["config"]["dtype"]) / sum(times)
