"""The harness's own tests (CPU, and a few marked ``cuda`` that run on the
card: ``python -m pytest benchmark/tests -m cuda``)."""
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def tiny_cell(name: str, **traffic):
    """The cell ``name`` cut to a size the CPU runs in seconds: F=4,
    65x65 images."""
    from benchmark import spec

    cell = spec.cell(name)
    cell["config"] = dict(cell["config"], F=4)
    cell["traffic"] = dict(cell["traffic"], image_hw=[65, 65], **traffic)
    return cell


def run_tiny(name: str, seed: int = 5, seconds: float = 0.5, variant=None, trace=False, **traffic):
    from benchmark.runners import early_exit

    return early_exit.run(tiny_cell(name, **traffic), seed, seconds, trace, time.perf_counter(),
                          device="cpu", variant=variant, log=lambda msg: None)
