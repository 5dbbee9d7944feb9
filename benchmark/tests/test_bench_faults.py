"""A whole run with the timed path broken underneath, the look for a chip
skipped: ``correct`` has to come out false. The cells are batch 1 on one
chip with no training step, so the faults they can have are an answer
altered where it is produced: the logits, the exit decision, the
confidence."""
import pytest
import torch

from auto_dynamic_deeplab_torch.models.decoded import EDM
from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

from .conftest import run_tiny


def _altered_logits(monkeypatch):
    real = DynamicInferenceEngine.infer_fused

    def infer_fused(self, x, threshold=0.0, confidence="edm"):
        logits, k, dt, conf = real(self, x, threshold, confidence)
        logits = logits.clone()
        logits.view(-1)[123] += 0.01 * float(logits.abs().max())
        return logits, k, dt, conf

    monkeypatch.setattr(DynamicInferenceEngine, "infer_fused", infer_fused)


def _altered_exit(monkeypatch):
    real = DynamicInferenceEngine._exits_now

    monkeypatch.setattr(DynamicInferenceEngine, "_exits_now",
                        staticmethod(lambda conf, kind, thr: not real(conf, kind, thr)))


def _altered_confidence(monkeypatch):
    real = EDM.forward
    monkeypatch.setattr(EDM, "forward", lambda self, x: real(self, x) * 1.01)


@pytest.mark.parametrize("fault, broken", [
    (_altered_logits, "logits_rel_err"),
    (_altered_exit, "scheduled_exit_misses"),
    (_altered_confidence, "conf_rel_err"),
])
@pytest.mark.parametrize("name", ("add_c2.xla.exit70", "add_c4.xla.exit70"))
def test_fault_is_not_correct(monkeypatch, name, fault, broken):
    fault(monkeypatch)
    rec = run_tiny(name, seed=21)
    assert not rec["correct"]
    check = rec["checks"][broken]
    assert not check["value"] <= check["limit"], rec["checks"]


def test_sound_run_is_correct():
    assert run_tiny("add_c2.xla.exit70", seed=21)["correct"]


def test_nan_logits_are_not_correct(monkeypatch):
    real = DynamicInferenceEngine.infer_fused

    def infer_fused(self, x, threshold=0.0, confidence="edm"):
        logits, k, dt, conf = real(self, x, threshold, confidence)
        return torch.full_like(logits, float("nan")), k, dt, conf

    monkeypatch.setattr(DynamicInferenceEngine, "infer_fused", infer_fused)
    assert not run_tiny("add_c2.xla.exit70", seed=4)["correct"]
