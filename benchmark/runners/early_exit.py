"""Early-exit segmentation in a closed loop: one client, batch 1, each image
sent as a pageable NHWC float32 host tensor to
``DynamicInferenceEngine.infer_fused``, the entry that ``cli.evaluate
--dynamic`` drives in its default mode (``Evaluation.dynamic_inference``),
with the EDM gate and the cell execution the traffic names.

A request's time runs from handing over the host image to its exit's
logits being ready on the device (a synchronize), the upload included.

Set-up makes the weights from the seed on the device, loads the same
tensors into the program and the reference, makes the image pool, and
warms up the one shape the traffic sends (the fused program's first call
captures its graphs). The window then sends requests until ``seconds``
have passed. With ``trace`` the first ``trace_blocks`` blocks run under
``torch.profiler``. After the window the program is freed and the plain
reference runs on a seeded sample of the requests (``correctness``).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import correctness, tracing
from .. import traffic as traffic_gen
from ..reference.add import Arch, Reference, all_specs, reference_numerics, split_weights
from ..weights import make_weights

VARIANTS = (None, "tf32", "bf16")  # the program as configured, and its two lower-precision paths


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program(cell: dict, model_w: dict, edm_w: dict, device: torch.device, variant: Optional[str]):
    """The port's engine, built as ``cli.evaluate --dynamic`` builds it, with
    the seeded weights loaded. ``variant`` switches on one of the program's
    own lower-precision paths: "tf32" (``runtime.ALLOW_TF32``, read when
    the engine resolves its device) or "bf16" (the models' ``dtype``)."""
    from auto_dynamic_deeplab_torch import runtime
    from auto_dynamic_deeplab_torch.cli.evaluate import CELL_EXEC
    from auto_dynamic_deeplab_torch.models import ADD, EDM
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    cfg, traffic = cell["config"], cell["traffic"]
    dtype = torch.bfloat16 if variant == "bf16" else None
    with torch.device(device):
        model = ADD(cfg["network_path"], cfg["C_index"], np.asarray(cfg["genotype"]), cfg["num_classes"],
                    F=cfg["F"], B=cfg["B"], low_level_layer=cfg["low_level_layer"], dtype=dtype,
                    **CELL_EXEC[traffic["cell_exec"]])
        edm = EDM(model.feature_channels(model.exit_layers[0]), dtype=dtype)
    model.load_state_dict(model_w)
    edm.load_state_dict(edm_w)
    allow = runtime.ALLOW_TF32
    runtime.ALLOW_TF32 = variant == "tf32"
    try:
        return DynamicInferenceEngine(model, edm=edm, num_classes=cfg["num_classes"], device=device)
    finally:
        runtime.ALLOW_TF32 = allow


def _confidences(engine, size, exit_index: int, first: float) -> list:
    """The confidence of each decision the last call took: the first as
    the entry returns it, the later ones (CUDA) from the captured graphs'
    outputs, which the next call overwrites."""
    n = min(exit_index, len(engine.exits) - 2) + 1
    graphs = getattr(engine.fused_program(size, "edm"), "_graphs", None)
    if graphs is None:
        return [first]
    return [first] + [float(graphs.decide[k][1][1][0]) for k in range(1, n)]


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        variant: Optional[str] = None, log=None) -> dict:
    """One run of an early-exit cell. Returns the window's host-clock
    record, the traced record (with ``trace``), the peak memory and the
    correctness checks."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    device = torch.device(device)
    cfg, traffic, workload = cell["config"], cell["traffic"], cell["workload"]
    arch = Arch(cfg)
    seeds = np.random.SeedSequence(int(seed) % 2 ** 63).generate_state(3, np.uint64)
    w_seed, img_seed, traffic_seed = (int(s) % 2 ** 63 for s in seeds)
    hw = tuple(int(v) for v in traffic["image_hw"])
    if int(traffic["batch"]) != 1 or int(traffic["clients"]) != 1 or traffic["loop"] != "closed":
        raise ValueError("this runner sends batch 1 from one client in a closed loop")

    # ------------------------------------------------------------ set-up
    marks = [("start", time.perf_counter())]
    flat = make_weights(all_specs(arch), w_seed, device)
    model_w, edm_w = split_weights(flat)
    engine = _program(cell, model_w, edm_w, device, variant)
    _sync(device)
    marks.append(("weights and program", time.perf_counter()))
    g = torch.Generator(device=device).manual_seed(img_seed)
    pool = torch.randn((int(traffic["pool_images"]), *hw, 3), generator=g, device=device).cpu()
    marks.append(("image pool", time.perf_counter()))
    early_thr, full_thr = float(traffic["early_threshold"]), float(traffic["full_threshold"])
    last = len(engine.exits) - 1
    engine.infer_fused(pool[0][None], early_thr, "edm")  # builds the kernels, captures the graphs
    _sync(device)
    marks.append(("first call", time.perf_counter()))
    for i, thr in enumerate((early_thr, full_thr, early_thr, full_thr)):
        engine.infer_fused(pool[i + 1][None], thr, "edm")
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; before the runner {marks[0][1] - t_start:.2f} s")

    # ------------------------------------------------------------ window
    rng = np.random.default_rng(traffic_seed)
    stream = traffic_gen.requests(traffic, rng)
    sample_rng = np.random.default_rng(traffic_seed + 1)
    per_kind = int(traffic["sample_per_kind"])
    reservoir = {True: [], False: []}
    seen = {True: 0, False: 0}
    n_traced = int(traffic["trace_blocks"]) * int(traffic["block"]) if trace else 0
    prof = mark = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        torch.zeros(1, device=device).add_(1)  # a session may lose its first kernel: let it be this one
        _sync(device)
        mark = torch.profiler.record_function(tracing.WINDOW)
        mark.__enter__()
    latencies, traced_exits, misses = [], [], 0
    replays0 = engine.replays
    traced_replays = None
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    t1 = t_w0
    for req in stream:
        if req.index >= n_traced and t1 >= deadline:
            break
        x = pool[req.image][None]
        t0 = time.perf_counter()
        logits, k, _, first = engine.infer_fused(x, req.threshold, "edm")
        _sync(device)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        misses += int(k != (0 if req.early else last))
        if req.index < n_traced:
            traced_exits.append(k)
            if req.index == n_traced - 1:
                mark.__exit__(None, None, None)
                traced_replays = engine.replays - replays0
                prof.__exit__(None, None, None)
        seen[req.early] += 1
        n = seen[req.early]
        slot = n - 1 if n <= per_kind else int(sample_rng.integers(n))
        if slot < per_kind:  # a reservoir sample of each kind, drawn from the seed
            reservoir[req.early][slot:slot + 1] = [{
                "image": req.image, "threshold": req.threshold, "logits": logits, "exit": k,
                "confs": _confidences(engine, hw, k, first)}]
        del logits
    window_s = t1 - t_w0
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = {"setup_s": setup_s, "latencies_s": latencies, "window_s": window_s,
              "completed": len(latencies), "attempted": len(latencies), "failed": misses,
              "memory_peak_bytes": int(memory_peak), "image_hw": hw, "arch": arch, "cell": cell}
    if trace:
        t_r = time.perf_counter()
        record["trace"] = tracing.reduce_profile(prof.events())
        record["traced_exits"] = traced_exits
        record["traced_replays"] = traced_replays
        log(f"trace: {len(record['trace']['device'])} device events reduced in {time.perf_counter() - t_r:.1f} s")

    # ------------------------------------------------- the program freed
    del engine, prof, stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference_numerics()
    reference = Reference(cfg, model_w, edm_w)
    samples = reservoir[True] + reservoir[False]
    t_c = time.perf_counter()
    record["checks"] = correctness.compare(samples, reference, pool, device, workload["limits"], misses)
    record["correct"] = correctness.passed(record["checks"])
    log(f"reference: {len(samples)} images compared in {time.perf_counter() - t_c:.1f} s")
    return record
