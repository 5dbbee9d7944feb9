"""Pipeline-parallel early-exit inference across devices
(parallel/pipeline.py of the JAX package).

The reference names its two genotype halves "device" and "cloud"
(Decoding/decode_autodeeplab.py:106-107); this is that split as a runtime.
The engine's segments (``train/dynamic.py``: decide_k, and final) are
assigned contiguously to stages, earlier stages taking the extra one. Each
stage holds a copy of only the modules its segments read (``stems``,
``cell_{i}``, ``low_level_conv``, ``aspp``, ``decoder``, ``conv_aspp_{e}``,
and the EDM when it decides) on its own device, and runs them through a
``DynamicInferenceEngine`` of its own, in the segment loop. The state
passes from one stage to the next by one ``.to(device)`` per tensor.

An image confident at stage s never reaches the stages after it. Kernel
launches are asynchronous per device, so a caller that does not wait for
the returned logits lets the next image's first stage run while this
image's last one still does. ``devices`` may name one device more than
once (two stages on ``cuda:0``, or on ``cpu``).
"""
from __future__ import annotations

import collections
import copy
from typing import Optional, Sequence, Tuple

import torch


def _to(state, device: torch.device):
    """The backbone state (dict / tuple / tensor / None) on ``device``."""
    if isinstance(state, dict):
        return {k: _to(v, device) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_to(v, device) for v in state)
    return None if state is None else state.to(device)


def _stage_model(model, keys):
    """A copy of the decoded network ``model`` that holds only its top-level
    modules ``keys`` (deep copies): a segment that reads another one fails
    on the missing attribute."""
    stage = copy.copy(model)  # the configuration; the module dicts are replaced below
    stage._parameters = collections.OrderedDict()
    stage._buffers = collections.OrderedDict()
    stage._modules = collections.OrderedDict(
        (k, copy.deepcopy(m)) for k, m in model._modules.items() if k in keys)
    stage._adapters = {c: stage._modules[f"conv_aspp_{c}"] for c in model._adapters if f"conv_aspp_{c}" in keys}
    return stage


class PipelinedDynamicInference:
    """Early-exit dynamic inference of ``model`` (a ``DecodedNet``) split
    over ``devices`` (default: every visible GPU) for NHWC images of
    ``size`` = (H, W). ``infer`` returns (logits (1, C, H, W) on the
    exiting stage's device, exit_index, confidence), the confidence of the
    last decision taken, as ``DynamicInferenceEngine.infer`` returns it."""

    def __init__(
        self,
        model,
        size: Tuple[int, int],
        devices: Optional[Sequence] = None,
        confidence: str = "entropy",
        threshold: float = 0.0,
        edm=None,
        num_classes: int = 19,
    ):
        from ..train.dynamic import DynamicInferenceEngine  # train.dynamic imports the models

        self.size = tuple(size)
        self.confidence = confidence
        self.threshold = float(threshold)
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        self.exits = model.exit_layers
        programs = [("decide", k) for k in range(len(self.exits) - 1)] + [("final", len(self.exits) - 1)]
        n_stages = min(len(devices), len(programs))
        per, extra = divmod(len(programs), n_stages)
        self.stages = []
        pos = 0
        for s in range(n_stages):
            take = per + (1 if s < extra else 0)
            progs = programs[pos:pos + take]
            pos += take
            keys = set().union(*(self._program_keys(model, prog) for prog in progs))
            decides = any(kind == "decide" for kind, _ in progs)
            sedm = copy.deepcopy(edm) if edm is not None and confidence == "edm" and decides else None
            engine = DynamicInferenceEngine(_stage_model(model, keys), edm=sedm, num_classes=num_classes,
                                            device=devices[s])
            self.stages.append({"device": engine.device, "programs": progs, "engine": engine})

    @staticmethod
    def _program_keys(model, prog) -> set:
        """The top-level modules program ``prog`` = (kind, k) reads: its
        cells, the stems for the first, the low-level conv where it lies in
        the segment, and the exit's head (every exit may decode it)."""
        _, k = prog
        exits = model.exit_layers
        e = exits[k]
        start = 0 if k == 0 else exits[k - 1] + 1
        keys = {f"cell_{i}" for i in range(start, e + 1)} | {"aspp", "decoder"}
        if start == 0:
            keys.add("stems")
        if start <= model.low_level_layer <= e:
            keys.add("low_level_conv")
        if f"conv_aspp_{e}" in model._modules:
            keys.add(f"conv_aspp_{e}")
        return keys

    def synchronize(self):
        """Wait for every stage's device."""
        for dev in {st["device"] for st in self.stages}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @torch.inference_mode()
    def warmup(self):
        """Every stage's segments once on zeros (with the EDM each exit's
        head too), so that no kernel build or cuDNN choice lands in a timed
        image."""
        carry = torch.zeros((1, *self.size, 3), dtype=torch.float32)
        for stage in self.stages:
            eng = stage["engine"]
            carry = _to(carry, stage["device"])
            for kind, k in stage["programs"]:
                if kind == "decide":
                    carry, _, _ = eng._decide(k, carry, self.size, self.confidence, self.threshold)
                    if self.confidence == "edm":  # its exits decode the head apart
                        eng._head(self.exits[k], carry, self.size)
                else:
                    eng._final(carry, self.size)
        self.synchronize()

    @torch.inference_mode()
    def infer(self, x):
        """Batch-1 early exit through the stages; one scalar readback per
        decision."""
        x = torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape[1:3]) != self.size or x.shape[0] != 1:
            raise ValueError(f"the pipeline takes one {self.size} image, got {tuple(x.shape)}")
        carry, conf_value = x, float("nan")
        for stage in self.stages:
            eng = stage["engine"]
            carry = _to(carry, stage["device"])  # the handoff
            for kind, k in stage["programs"]:
                if kind == "final":
                    return eng._final(carry, self.size), k, conf_value
                carry, conf, logits = eng._decide(k, carry, self.size, self.confidence, self.threshold)
                conf_value = float(conf[0])
                if eng._exits_now(conf_value, self.confidence, self.threshold):
                    if logits is None:  # the EDM decides on the feature: decode the head now
                        logits = eng._head(self.exits[k], carry, self.size)
                    return logits, k, conf_value
        raise AssertionError("the pipeline ended without its final segment")
