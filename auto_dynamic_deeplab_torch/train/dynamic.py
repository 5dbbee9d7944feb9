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
(N, C, H, W). Three modes, as in the JAX package:

  * ``infer``: batch 1, the segments run eagerly (JAX: one compiled
    program a segment);
  * ``infer_fused`` (``fused_program``): batch 1, the JAX single-program
    mode. JAX compiles the whole image as one program whose exit decisions
    are a ``lax.cond`` chain; PyTorch has no device-side ``cond`` a graph
    can hold, so on CUDA each segment becomes one CUDA graph, captured once
    per input shape and replayed, with the one scalar readback per
    decision between graphs;
  * ``infer_batch``: a batch whose continuing images are compacted into
    padded buckets at every exit.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.confidence import entropy_argmax, scratch_buffers
from ..ops.confidence import confidence_max
from ..runtime import resolve_device


class DynamicInferenceEngine:
    """Moves ``model`` (and ``edm``) to ``device`` (cuda unless the caller
    asks for the CPU; raises without a GPU) and puts them in eval mode.

    ``captures`` and ``replays`` count the CUDA graphs the engine captured
    and replayed (``infer_fused`` on CUDA)."""

    def __init__(self, model, edm=None, num_classes: int = 19, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.edm = None if edm is None else edm.to(self.device).eval()
        self.num_classes = num_classes
        self.exits = model.exit_layers
        self._programs: Dict[tuple, FusedProgram] = {}
        self._stream: Optional[torch.cuda.Stream] = None  # the graphs' one stream
        self._pool = None  # the graphs' one memory pool
        self.captures = 0
        self.replays = 0

    # ------------------------------------------------------------ segments

    def _confidence(self, state, exit_layer: int, size, confidence: str, threshold):
        """(confidence (N,), logits or None) at an exit. ``threshold`` (read
        by the max signal only) is a float or a 0-d fp32 tensor."""
        if confidence == "edm":
            feature = self.model.exit_feature(state, exit_layer)
            return self.edm(feature)[:, 0], None
        logits = self.model.exit_logits(state, exit_layer, size, class_leading=True)
        if confidence == "entropy":
            return entropy_argmax(logits, self.num_classes, class_axis=1)[0], logits
        return confidence_max(logits, threshold, class_axis=1), logits

    def _decide(self, k: int, carry, size, confidence: str, threshold):
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

    def _run_segments(self, x, size, confidence: str, threshold):
        """Every segment once, in order (each head too, for EDM)."""
        carry = x
        for k in range(len(self.exits) - 1):
            carry, _, _ = self._decide(k, carry, size, confidence, threshold)
            if confidence == "edm":
                self._head(self.exits[k], carry, size)
        self._final(carry, size)

    # -------------------------------------------------------------- driver

    @torch.inference_mode()
    def warmup(self, input_shape, confidence: str = "edm", threshold: float = 0.0):
        """Run every segment once on zeros of ``input_shape`` (NHWC): builds
        the kernels and lets cuDNN pick its algorithms before timing."""
        x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=self.device)
        self._run_segments(x, tuple(input_shape[1:3]), confidence, threshold)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, torch.float32)

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
        x = self._input(x)
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

    # -------------------------------------------------------- batched mode

    @torch.inference_mode()
    def infer_batch(self, x, threshold: float = 0.0, confidence: str = "edm",
                    bucket_sizes: Optional[List[int]] = None):
        """Batched early exit (JAX ``infer_batch``): at each exit the images
        that exit are finalized at that exit, and the continuing ones are
        gathered into the smallest bucket that holds them, padded by
        repeating the last kept image, before the later segments run.
        Returns (logits (N, C, H, W) fp32 on the engine's device,
        exit_index (N,) int64 on the CPU).

        The segments run eagerly. Unlike the JAX loop, a decision reads
        only the rows of real images, so the pad rows never count as
        images from the third exit on."""
        x = self._input(x)
        n, size = x.shape[0], tuple(x.shape[1:3])
        if bucket_sizes is None:
            bucket_sizes = sorted({2 ** i for i in range(0, 16) if 2 ** i < n} | {n})
        carry = x
        alive = np.arange(n)
        out: Optional[torch.Tensor] = None
        exit_idx = np.full(n, len(self.exits) - 1, np.int64)

        def finalize(logits: torch.Tensor, rows: np.ndarray, images: np.ndarray):
            nonlocal out
            if out is None:
                out = torch.empty((n, *logits.shape[1:]), dtype=torch.float32, device=self.device)
            src = torch.as_tensor(rows, device=self.device)
            out.index_copy_(0, torch.as_tensor(images, device=self.device), logits.index_select(0, src).float())

        for k in range(len(self.exits) - 1):
            carry, conf, maybe_logits = self._decide(k, carry, size, confidence, threshold)
            conf = conf[: len(alive)].float().cpu().numpy()  # one readback per decision
            exits_now = self._exits_now(conf, confidence, threshold)
            if exits_now.any():
                head = self._head(self.exits[k], carry, size) if confidence == "edm" else maybe_logits
                rows = np.nonzero(exits_now)[0]
                finalize(head, rows, alive[rows])
                exit_idx[alive[rows]] = k
            keep = np.nonzero(~exits_now)[0]
            if keep.size == 0:
                return out, torch.from_numpy(exit_idx)
            if keep.size < len(alive):
                bucket = min(b for b in bucket_sizes if b >= keep.size)
                pad = np.concatenate([keep, np.repeat(keep[-1], bucket - keep.size)])
                carry = _gather(carry, torch.as_tensor(pad, device=self.device))
                alive = alive[keep]

        finalize(self._final(carry, size), np.arange(len(alive)), alive)
        return out, torch.from_numpy(exit_idx)

    # ---------------------------------------------- single-program mode

    def fused_program(self, size, confidence: str = "edm") -> "FusedProgram":
        """The single-program dynamic inference for images of ``size`` =
        (H, W): fn(x, threshold) -> (logits, exit_index, confidence). Kept
        by ``("fused", size, confidence)``, as JAX keys its program: the
        threshold is a run-time value, so a new threshold captures
        nothing."""
        key = ("fused", tuple(size), confidence)
        if key not in self._programs:
            self._programs[key] = FusedProgram(self, tuple(size), confidence)
        return self._programs[key]

    def infer_fused(self, x, threshold: float = 0.0, confidence: str = "edm"):
        """The single-program mode; same return contract as ``infer`` but
        for the confidence: the first decision's, as the JAX fused program
        carries it up (its ``descend``); nan with one exit."""
        x = self._input(x)
        program = self.fused_program(tuple(x.shape[1:3]), confidence)
        self._sync()
        t0 = time.perf_counter()
        logits, exit_index, conf = program(x, threshold)
        self._sync()
        return logits, exit_index, time.perf_counter() - t0, conf

    def _graph_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream


def _gather(state, idx: torch.Tensor):
    """The backbone state's rows ``idx``, each tensor in its memory format."""
    if isinstance(state, dict):
        return {k: _gather(v, idx) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_gather(v, idx) for v in state)
    if state is None:
        return None
    rows = state.index_select(0, idx)
    if state.dim() == 4 and state.is_contiguous(memory_format=torch.channels_last):
        return rows.contiguous(memory_format=torch.channels_last)
    return rows


class _GraphSet:
    """The CUDA graphs of one fused program and the static tensors they read
    and write: every static input and output stays referenced here, so no
    graph's transient memory in the shared pool overlaps a buffer that
    another graph reads, whatever order the decisions replay them in."""

    def __init__(self, x: torch.Tensor, threshold: torch.Tensor):
        self.x = x  # the image, copied in before every replay
        self.threshold = threshold  # 0-d fp32, a static input of every graph
        self.threshold_value = float("nan")  # what ``threshold`` holds
        self.decide: List[Tuple[torch.cuda.CUDAGraph, tuple]] = []  # (graph, (state, conf, logits))
        self.heads: List[Tuple[torch.cuda.CUDAGraph, torch.Tensor]] = []  # EDM only
        self.final: Optional[Tuple[torch.cuda.CUDAGraph, torch.Tensor]] = None
        self.scratch: tuple = ()  # K2's buffers that the graphs write


class FusedProgram:
    """``DynamicInferenceEngine.fused_program``: fn(x, threshold) ->
    (logits (1, C, H, W), exit_index, first decision's confidence) for one
    NHWC image.

    On CUDA, the first call runs every segment once, eagerly, on the
    engine's graph stream (this builds the kernels, fills the packed-weight
    caches, K2's Triton JIT and its per-stream scratch, and cuDNN's
    choices, none of which may happen inside a capture), then
    captures one CUDA graph for each segment (decide_k for every exit but
    the last, head_k for EDM, final) into the engine's one memory pool.
    Every call replays them on that one stream: the stream the graphs were
    captured on, whose K2 scratch they bake in, so no eager K2 launch on
    those buffers can run between or beside them. The threshold is a 0-d
    fp32 device tensor that the graphs read (only the max signal uses it),
    filled when it changes: a new threshold captures nothing. A failed
    capture or replay raises; there is no eager fallback. The logits are
    cloned out of the graph's static output, so the next replay does not
    overwrite them.

    On the CPU (tests) the engine's eager segment loop (``infer``'s) runs.
    Either way the exit decision compares with the threshold rounded to
    fp32, as the JAX program does."""

    def __init__(self, engine: DynamicInferenceEngine, size, confidence: str):
        self.engine, self.size, self.confidence = engine, size, confidence
        self._graphs: Optional[_GraphSet] = None  # captured on the first CUDA call

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor, threshold: float):
        eng = self.engine
        x = eng._input(x)
        if x.shape[0] != 1 or tuple(x.shape[1:3]) != self.size:
            raise ValueError(f"the fused program takes one {self.size} image, got {tuple(x.shape)}")
        thr = float(np.float32(threshold))
        if eng.device.type == "cpu":
            logits, exit_index, _, confs = eng._infer(x, thr, self.confidence)
            return logits, exit_index, confs[0] if confs else float("nan")
        return self._replay(x, thr)

    def _replay(self, x: torch.Tensor, thr: float):
        eng = self.engine
        if self._graphs is None:
            self._graphs = self._capture(tuple(x.shape))
        gs = self._graphs
        stream = eng._graph_stream()
        caller = torch.cuda.current_stream(eng.device)
        gs.x.copy_(x)
        if gs.threshold_value != thr:
            gs.threshold.fill_(thr)
            gs.threshold_value = thr
        stream.wait_stream(caller)
        first = float("nan")
        with torch.cuda.stream(stream):
            for k, (graph, (_, conf, logits)) in enumerate(gs.decide):
                graph.replay()
                eng.replays += 1
                value = float(conf[0])  # the one scalar readback per decision
                first = value if k == 0 else first
                if eng._exits_now(value, self.confidence, thr):
                    exit_index = k
                    if self.confidence == "edm":
                        gs.heads[k][0].replay()
                        eng.replays += 1
                        logits = gs.heads[k][1]
                    break
            else:
                exit_index = len(eng.exits) - 1
                gs.final[0].replay()
                eng.replays += 1
                logits = gs.final[1]
        caller.wait_stream(stream)
        # the next replay waits for this clone (stream.wait_stream above)
        return logits.clone(), exit_index, first

    def _capture(self, shape) -> _GraphSet:
        eng, size, conf_kind = self.engine, self.size, self.confidence
        stream = eng._graph_stream()
        gs = _GraphSet(torch.zeros(shape, dtype=torch.float32, device=eng.device),
                       torch.zeros((), dtype=torch.float32, device=eng.device))
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            eng._run_segments(gs.x, size, conf_kind, gs.threshold)
        stream.synchronize()

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=eng._pool, stream=stream):
                out = fn()
            eng.captures += 1
            return graph, out

        carry = gs.x
        for k in range(len(eng.exits) - 1):
            gs.decide.append(capture(lambda: eng._decide(k, carry, size, conf_kind, gs.threshold)))
            carry = gs.decide[-1][1][0]
            if conf_kind == "edm":
                gs.heads.append(capture(lambda: eng._head(eng.exits[k], carry, size)))
        gs.final = capture(lambda: eng._final(carry, size))
        gs.scratch = scratch_buffers(eng.device, stream.cuda_stream)
        return gs

