"""BENCHMARK.json against the rules it is held to, the files it names,
and the result line's shape."""
import json
import re
import subprocess
import sys

from benchmark import correctness, run, spec
from benchmark.spec import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        cell = spec.cell(w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["source"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_result_line_has_checks_last():
    from .conftest import run_tiny, tiny_cell

    rec = run_tiny("add_c2.xla.exit70", seed=1)
    out = run.result_line(tiny_cell("add_c2.xla.exit70"), rec, False, "NVIDIA H100 80GB HBM3", 1)
    assert list(out)[-1] == "checks" and list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(out["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "images_per_s", "setup_s"}
    json.dumps(out, allow_nan=False)


def test_a_number_without_a_limit_is_printed_and_not_compared():
    checks = {"logits_rel_err": {"value": 1e-5, "limit": 1e-3}, "conf_rel_err": {"value": 1.0, "limit": None}}
    assert correctness.passed(checks)
    assert correctness.lines(checks)[1] == "check conf_rel_err 1.0 not compared"
    checks["logits_rel_err"]["value"] = float("nan")
    assert not correctness.passed(checks)


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax": 1, "jax.numpy": 1, "jaxtyping": 1, "auto_dynamic_deeplab_tpu.models": 1,
            "auto_dynamic_deeplab_torch": 1, "flax.linen": 1, "orbax_like": 1, "optax": 1}
    assert run.forbidden_modules(mods) == ["auto_dynamic_deeplab_tpu.models", "flax.linen", "jax", "jax.numpy", "optax"]


def test_a_run_loads_no_jax():
    """A whole run at a small size on the CPU, in a fresh process: the
    harness and the program load no module of JAX or of the JAX package."""
    code = (
        "import sys, time\n"
        "from benchmark import run\n"
        "from benchmark.tests.conftest import run_tiny\n"
        "rec = run_tiny('add_c2.flat.exit70', seconds=0.3, trace=True)\n"
        "run.result_line(__import__('benchmark.tests.conftest', fromlist=['x']).tiny_cell('add_c2.flat.exit70'),"
        " rec, True, 'cpu', 1)\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_imports_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|auto_dynamic_deeplab_tpu)\b", re.M)
    for path in HERE.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "add_c2.xla.exit70",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
