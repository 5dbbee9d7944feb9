"""The whole step's share of the chip's peak (%): the FLOP the plain
reference needs for the segments each traced image ran
(``counts.flops.segment_flops``: convolutions and matmuls) over the traced
window's seconds and the tensor-core peak of the configuration's precision
(495 TFLOP/s for float32 operands)."""
from benchmark.counts import flops, peaks
from benchmark.reference.add import image_segments


def read(record):
    tr = record.get("trace")
    if not tr or not record.get("traced_exits"):
        return None
    cfg, arch = record["cell"]["config"], record["arch"]
    seg = flops.segment_flops(cfg, record["image_hw"])
    total = sum(seg[s] for k in record["traced_exits"] for s in image_segments(arch, k))
    window = tr["window"][1] - tr["window"][0]
    return 100.0 * total / window / peaks.TENSOR_FLOPS[cfg["dtype"]]
