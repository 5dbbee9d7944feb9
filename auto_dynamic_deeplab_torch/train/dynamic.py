"""Early-exit dynamic inference engine (train/dynamic.py of the JAX package;
the reference's ADD.dynamic_inference, modeling/ADD.py:379-488).

The backbone is cut at every exit into segments:

    decide_0 = stem + cells[0..e0] + confidence_0
    decide_k =        cells[e_{k-1}+1..e_k] + confidence_k
    final    =        cells[e_{K-1}+1..end] + head
    head_k   = exit head at e_k (run only when exiting there, for EDM)

Each decision reads back one scalar; stopping early means the later
segments never run. For the entropy and max signals the decision also
produces the exit's logits (the reference decodes the head before judging);
the entropy signal is K2 (kernels/confidence.py) on CUDA logits. Logits are
(N, C, H, W). PyTorch runs eagerly, so the segments are plain calls;
``fused_program`` (a CUDA-graph analogue of the JAX single-program mode)
and the bucketed ``infer_batch`` are later work (ROADMAP).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..kernels.confidence import entropy_argmax
from ..ops.confidence import confidence_max
from ..runtime import resolve_device


class DynamicInferenceEngine:
    """Moves ``model`` (and ``edm``) to ``device`` (cuda unless the caller
    asks for the CPU; raises without a GPU) and puts them in eval mode."""

    def __init__(self, model, edm=None, num_classes: int = 19, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.edm = None if edm is None else edm.to(self.device).eval()
        self.num_classes = num_classes
        self.exits = model.exit_layers

    # ------------------------------------------------------------ segments

    def _confidence(self, state, exit_layer: int, size, confidence: str, threshold: float):
        """(confidence (N,), logits or None) at an exit."""
        if confidence == "edm":
            feature = self.model.exit_feature(state, exit_layer)
            return self.edm(feature)[:, 0], None
        logits = self.model.exit_logits(state, exit_layer, size, class_leading=True)
        if confidence == "entropy":
            return entropy_argmax(logits, self.num_classes, class_axis=1)[0], logits
        return confidence_max(logits, threshold, class_axis=1), logits

    def _decide(self, k: int, carry, size, confidence: str, threshold: float):
        """Cells up to exit k (plus the stem when k == 0) and its confidence."""
        e = self.exits[k]
        start = 0 if k == 0 else self.exits[k - 1] + 1
        state = self.model.stem_state(carry) if k == 0 else carry
        state = self.model.run_cells(state, start, e)
        conf, logits = self._confidence(state, e, size, confidence, threshold)
        return state, conf, logits

    def _final(self, carry, size) -> torch.Tensor:
        """Last segment and the final shared head."""
        e = self.exits[-1]
        start = self.exits[-2] + 1 if len(self.exits) > 1 else 0
        state = self.model.stem_state(carry) if len(self.exits) == 1 else carry
        state = self.model.run_cells(state, start, e)
        return self.model.exit_logits(state, e, size, class_leading=True)

    def _head(self, exit_layer: int, state, size) -> torch.Tensor:
        return self.model.exit_logits(state, exit_layer, size, class_leading=True)

    @staticmethod
    def _exits_now(conf, confidence: str, threshold: float):
        if confidence == "edm":
            return conf <= threshold  # confident → exit (ADD.py:421-432)
        if confidence == "entropy":
            return conf < threshold  # low entropy → exit (ADD.py:478)
        return conf > threshold  # high max-prob coverage → exit (ADD.py:481)

    # -------------------------------------------------------------- driver

    @torch.inference_mode()
    def warmup(self, input_shape, confidence: str = "edm", threshold: float = 0.0):
        """Run every segment once on zeros of ``input_shape`` (NHWC): builds
        the kernels and lets cuDNN pick its algorithms before timing."""
        x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=self.device)
        size = tuple(input_shape[1:3])
        carry = x
        for k in range(len(self.exits) - 1):
            carry, _, _ = self._decide(k, carry, size, confidence, threshold)
            if confidence == "edm":
                self._head(self.exits[k], carry, size)
        self._final(carry, size)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def infer(self, x, threshold: float = 0.0, confidence: str = "edm"):
        """One NHWC input (batch 1). Returns (logits (N, C, H, W),
        exit_index, latency_s, confidence_value), the confidence of the
        last decision taken, as JAX ``infer`` returns it (nan with one
        exit). The latency brackets the device work with synchronizes
        (reference: cuda.synchronize + perf_counter, ADD.py:380-437)."""
        logits, exit_index, latency, confs = self._infer(x, threshold, confidence)
        return logits, exit_index, latency, confs[-1] if confs else float("nan")

    @torch.inference_mode()
    def _infer(self, x, threshold: float, confidence: str):
        """``infer`` with every decision's confidence, in order."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        size = tuple(x.shape[1:3])
        self._sync()
        t0 = time.perf_counter()

        carry = x
        logits: Optional[torch.Tensor] = None
        confs = []
        exit_index = len(self.exits) - 1
        for k in range(len(self.exits) - 1):
            carry, conf, maybe_logits = self._decide(k, carry, size, confidence, threshold)
            confs.append(float(conf[0]))  # the one scalar readback per decision
            if self._exits_now(confs[-1], confidence, threshold):
                exit_index = k
                logits = (
                    self._head(self.exits[k], carry, size)
                    if confidence == "edm"
                    else maybe_logits
                )
                break
        if logits is None:
            logits = self._final(carry, size)

        self._sync()
        latency = time.perf_counter() - t0
        return logits, exit_index, latency, confs
