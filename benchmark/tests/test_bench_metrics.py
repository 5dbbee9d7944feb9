"""Each metric reader on a synthetic record: two traced images of C=2 (one
early, one full) over a 10 ms window."""
import pytest

from benchmark import spec, tracing
from benchmark.counts import flops, peaks, stems
from benchmark.reference.add import Arch

K1 = "void stems_kernel<float>(StemArgs)"


def _record():
    cell = spec.cell("add_c2.flat.exit70")
    device = [
        (K1, 0.0000, 0.0015),
        ("void block_kernel<float, 1>(Args)", 0.0016, 0.0020),
        ("void sep_stage_kernel<float>(Args)", 0.0020, 0.0021),
        ("Memcpy HtoD (Pageable -> Device)", 0.0021, 0.0040),
        (K1, 0.0050, 0.0065),
        ("void dense_stage_kernel<float>(Args)", 0.0064, 0.0070),
        ("cudnn_conv", 0.0080, 0.0090),
    ]
    host = [("aten::copy_", 0.0020, 0.0049), ("cudaStreamSynchronize", 0.0070, 0.0100)]
    return {
        "cell": cell, "arch": Arch(cell["config"]), "image_hw": (1025, 2049),
        "latencies_s": [0.010, 0.020, 0.030, 0.040], "window_s": 0.2, "completed": 4, "setup_s": 12.5,
        "trace": {"window": (0.0, 0.010), "device": device, "host": host},
        "traced_exits": [0, 1], "traced_replays": 4,
    }


def _read(name, record=None):
    return spec.reader(name)(record or _record())


def test_host_clock_metrics():
    assert _read("latency_p50_ms") == pytest.approx(25.0)
    assert _read("latency_p95_ms") == pytest.approx(38.5)
    assert _read("images_per_s") == pytest.approx(20.0)
    assert _read("setup_s") == 12.5


def test_trace_metrics():
    assert _read("engine.replays_per_image") == 2.0
    assert _read("model.kernels_per_image") == 3.0  # six kernels, the copy left out
    # kernels cover [0, 1.5], [1.6, 2.1], [5.0, 7.0], [8.0, 9.0] ms of 10
    assert tracing.busy_s(_record()["trace"]) == pytest.approx(0.0050)
    assert _read("device_idle_share") == pytest.approx(50.0)
    assert _read("device.busy_ms_per_image") == pytest.approx(2.5)
    assert _read("k1_stems_roofline") == pytest.approx(100 * 2 * stems.bound_s(1025, 2049) / 0.003)
    rec = _record()
    seg = flops.segment_flops(rec["cell"]["config"], (1025, 2049))
    want = (2 * seg["decide_0"] + seg["head_0"] + seg["final"]) / 0.010 / peaks.TF32_FLOPS * 100
    assert _read("mfu") == pytest.approx(want)
    share = _read("cell_kernels_roofline")
    assert 0 < share < 100


def test_readers_find_nothing_to_read():
    rec = _record()
    rec["trace"]["device"] = [(n, a, b) for n, a, b in rec["trace"]["device"]
                              if "stage" not in n and "block" not in n and "stems" not in n]
    assert _read("cell_kernels_roofline", rec) is None
    assert _read("k1_stems_roofline", rec) is None
    bare = dict(_record(), trace=None, traced_exits=None, traced_replays=None)
    for m in ("mfu", "device_idle_share", "device.busy_ms_per_image", "model.kernels_per_image",
              "engine.replays_per_image"):
        assert _read(m, bare) is None


def test_breakdown():
    tr = _record()["trace"]
    ops = tracing.device_ops(tr)
    assert ops[0][0] == K1 and ops[0][1] == pytest.approx(0.003)
    assert len(ops) <= 10
    gaps = dict(tracing.idle_gaps(tr))
    # [2.1, 5.0] under the copy, [7.0, 8.0] and [9.0, 10.0] under the synchronize
    assert gaps["aten::copy_"] == pytest.approx(0.0029)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.002)


def test_every_metric_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
