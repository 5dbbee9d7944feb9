"""What a run reads from the checkout, found by name: the cell in
``BENCHMARK.json`` and ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, and
one reader ``metrics/<metric>.py`` for each metric the cell reports."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """{"name", "workload": its file, "entry": its BENCHMARK.json entry,
    "config", "traffic", "end_to_end": [metric entries], "per_layer":
    [metric entries]}. Raises when the files and BENCHMARK.json disagree."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has {len(entries)} workloads named {name!r}")
    entry = entries[0]
    workload = _load(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {workload[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"BENCHMARK.json has {len(configs)} configs named {entry['config']!r}")
    config = _load(ROOT / configs[0]["file"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name, "workload": workload, "entry": entry, "config": config,
        "traffic": _load(HERE / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(metric: str) -> Callable[[dict], object]:
    """``read(record)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], record: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric in ``entries`` whose reader
    finds something to read in ``record``."""
    out = {}
    for m in entries:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
