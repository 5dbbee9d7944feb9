"""On the card, at each cell's own size and load: the program passes the
comparison, and both lower-precision controls fail it (the program's TF32
path and its bf16 path). ``python -m pytest benchmark/tests -m cuda``."""
import time

import pytest

from benchmark import spec
from benchmark.runners import early_exit

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("variant", (None, "tf32", "bf16"))
def test_cell_control_fails_and_program_passes(cuda_device, name, variant):
    rec = early_exit.run(spec.cell(name), 3_000_000_019, 1.5, False, time.perf_counter(), device=cuda_device,
                         variant=variant)
    assert rec["correct"] == (variant is None), rec["checks"]
