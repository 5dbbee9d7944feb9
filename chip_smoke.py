#!/usr/bin/env python3
"""Drive the PyTorch port (auto_dynamic_deeplab_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --phases 1,2,3,4  # a subset (device, K1, K2, K3-K6)
    python3 chip_smoke.py --phases 1,2,3,10,9  # training, with K1's and K2's checks
    python3 chip_smoke.py --phases 1,11        # NAS search
    python3 chip_smoke.py --phases 1,2,3,12,9  # the input pipeline, with K1's and K2's checks
    python3 chip_smoke.py --phases 1,13        # the parallel modes
    python3 chip_smoke.py --phases 1,14        # the other --cell-exec values and --flops
    python3 chip_smoke.py --phases 1,15        # spatial sharding (every cell execution) and tensor parallelism
    python3 chip_smoke.py --phases 1,16        # the JAX package's orbax checkpoints restored

Phases, each printing JSON lines and raising on failure:
  1. device: the card, its power limit and the kernels' build time (every
     csrc/*.cu, one nvcc each, all at once);
  2. K1 (stems, CUDA C++, tensor cores) against its plain version at the
     main path's shapes and at ragged ones (batch 2 too), fp32 (TF32 off)
     and bf16, each with its plan (tile, shared memory, blocks); the
     full-size rows with CUDA-event and profiler (device) times, achieved
     TFLOP/s and the bound;
  3. K2 (entropy + argmax, Triton) against its plain version, each call
     compared bitwise with two more (N=3 too); the full-size rows with
     CUDA-event and profiler (device) times and the count of device
     kernels one call launches, which must be 1;
  4. K3-K6 (the cell kernels, CUDA C++) against their plain versions at
     the flagship's DAG widths (C, H, W) = (40, 129, 257), (80, 65, 129),
     (160, 33, 65), fp32 (TF32 off) and bf16: every block of the flagship
     genotype, a skip+sep and a one-edge block, and each conv op through
     K4, K5 (two passes) and K6, with the route each block takes; every
     row also gives its plan (tile, N-slices, warp groups, grid blocks),
     achieved TFLOP/s and device time by torch.profiler (without the
     host's share; K6 also cuDNN's), and each level the sum of K3's times
     over the flagship's five blocks (one cell);
  5. the flagship ADD (C=2, F=20, B=5, 19 classes, seeded weights and BN
     statistics, fp32) per-exit logits on the card against the same model
     on the CPU at 129x257, with --cell-exec xla and flat;
  6. the main paths through their entry point, cli.evaluate.main, on
     1025x2049 synthetic images: static, --dynamic entropy at thresholds 0
     and 1.01, --dynamic edm, each with --cell-exec xla and flat, then a
     mixed genotype (pools, skip, none) with flat. --dynamic runs the
     single-program mode (one CUDA graph a segment, replayed), as the JAX
     CLI does: a replay calls no wrapper, so torch.profiler counts the
     kernels by name (K1 once an image and once for the warm-up, K2 once
     a decision, the flat runs' K3-K6 what the routes predict); the
     wrappers' counts show the warm-up and the capture. One segment-loop
     run (fused=False) for each --cell-exec keeps the wrapper counts: every
     kernel's count is set to 0 just before each run and read just after;
  7. the flagship engine (C=2, F=20, B=5, 19 classes, 1025x2049, batch 1,
     with an EDM), fp32 and bf16, xla and flat: the fused graphs against
     the segment loop (same exit and bitwise-equal logits for entropy at
     thresholds 0 and 1.01, max and edm; a new threshold captures
     nothing), then the p50 of 20 images after 3 warm-up ones in each mode,
     run segment loop, fused, fused, segment loop, early exit and full
     depth, with host launches (runtime and driver calls) and readbacks
     per image counted by the profiler in both modes, the device busy
     share and peak memory; the segment loop's cell launches per image
     against the routes; the fused graphs' kernels by the profiler, in a
     process of its own (a fresh engine's warm-up, capture and two
     replays);
  8. the trained weights (artifacts/product_proof, flagship topology, F=8,
     7 classes) read with the port's flax-msgpack reader, on the 32
     beacon validation images at 321x321, fp32 and bf16: static per-exit
     mIoU and the EDM-gated fused run at meta.json's threshold against
     the JAX-CPU recording (tests/torch_product_proof_ref.json; fp32 also
     each image's exit-0 EDM confidence, within TRAINED_FP32_CONF_TOL), then
     infer_batch on 8 of the images (both exits) against per-image
     infer_fused;
  10. training (stages 2 and 3), run before the summary: three fp32
     steps (TF32 off) of a small ADD on the card against the CPU;
     cli.train.main on the flagship (C=2, F=20, B=5, 19 classes) at
     769x769, batch 4, fp32 (2 epochs of 10 steps) and bf16 (1 epoch),
     each validating 10 images at batch 1 after every epoch (one K1 an
     image, one K2 an exit), with the step time (the median after the
     first step),
     images/s and peak memory; bf16, 20 steps on one batch, whose loss must
     fall; cli.train_edm --resume on 8 images at 1025x2049 (one K1 and one
     K2 an image; K2's entropies against its plain version);
     cli.evaluate --resume, whose per-exit mIoU must equal the trainer's
     last validation; cli.evaluate --dynamic --confidence edm --resume
     --edm-resume. Everything is written under a temporary directory;
  11. NAS search (stage 1), run before the summary: one fp32 weight step
     and one arch step (TF32 off) of a tiny ModelSearch and a tiny
     ModelNetSearch on the card against the CPU (losses, weight and arch
     gradients, the updated arch, with tests/test_torch_search.py's
     tolerances); cli.search.main at the published net_supernet recipe
     (12 layers, F=20, B=5, C=2, 321x321, batch 16: 2 weight and 2 arch
     steps, validation of 8 images at batch 1), with its step times (the
     median after the first), images/s, peak memory, a valid 12-layer
     Viterbi path in arch_epoch_0 and betas that moved, then --resume
     auto --epochs 2, which must start at epoch 1 with both optimizers'
     states; the mixed supernet through cli.search --network supernet (12
     layers, F=8, B=5, batch 2, --no-remat, two bilevel iterations: the
     seed-2 half needs 4 images for one batch of 2) with its genotype;
     cli.search_layer --network baseline_path (F=20, batch 16, two
     iterations). No kernel lies on this path: every count must stay 0;
  12. the file datasets and the input pipeline, run before the summary:
     the installation (Pillow's version or null, g++'s, the native C++
     augmentation library built and loaded; the phase fails without
     Pillow, which decodes the frames); a Cityscapes-layout PNG tree
     of 16 seeded 1024x2048 train frames over two cities and 2 val frames
     in a temporary directory; the device augment on the card against the
     CPU at 769x769 (batch 4, scales 0.5-2, both flips), the eval
     preprocess at 1025x2049, the native engine against numpy; cli.train
     --dataset cityscapes --data-root at the flagship's 769x769, batch 4,
     with and without --device-augment, fp32 and bf16 (2 epochs of 4
     steps, validation of the 2 val frames at 1025x2049: one K1 an image,
     one K2 an exit), in turns (host, device, device, host), with the
     median step ms of each route over its two runs; the host loader
     alone at 4 workers (native engine, PIL, decode only) and the device
     augment alone (upload and augment, CUDA events); cli.search on the
     two_train_seg halves at the net_supernet recipe, batch 4 (no kernel);
     cli.train_edm --dataset cityscapes_edm (one K1 and one K2 a frame) and
     cli.evaluate --dynamic --confidence edm on the val frames;
  13. the parallel modes, run before the summary: in a child process
     under a world-1 NCCL process group (``parallel.distributed.initialize``
     from MASTER_ADDR / WORLD_SIZE / RANK), one fp32 TrainStep of a small
     ADD with cross-replica BN against the single-device step
     (PARALLEL_TOL), cli.train --sync-bn on the flagship at 769x769, batch
     4 (1 epoch of 6 steps, validating the 8 synthetic images at batch 1:
     one K1 an image, one K2 an exit) with its median step ms beside phase
     10's, and cli.search at the net_supernet recipe (batch 16, two
     bilevel iterations) under the group and with --no-dp, whose first
     weight-step losses must agree and which run no kernel; then
     PipelinedDynamicInference on the flagship at 1025x2049 over two
     stages on cuda:0, fp32 and bf16, xla and flat: at entropy thresholds
     1.01 and 0 the same exit and bitwise-equal logits as the engine's
     segment loop, the p50 of 20 images (after 3) early exit and full
     depth, and each block's K1, K2 and K3-K6 launches against the
     routes; last, dynamic_inference(pipeline_devices=GPUs+1) must raise;
  14. the JAX CLI's other --cell-exec values, run before the summary:
     seeded flagship weights with drifted BN statistics, saved as a
     checkpoint that every run reads through cli.evaluate --resume; with
     packed, flat-packed and dense-sep, each exit's fp32 logits on 2
     1025x2049 images against xla's (1e-3 of max|ref|), and the fused
     --dynamic entropy exits of 8 images at the median of their exit-0
     confidences (the same exit wherever the confidence lies farther than
     1e-4 from it); cli.evaluate.main static with --flops (params equal to
     the xla model's count) and --dynamic (the fused graphs, kernels
     counted as in phase 6) for each; the mixed genotype under
     flat-packed (K4 and K6 launch); utils/profiling's device_time of one
     forward and a trace written; then, for fp32 and bf16, each variant's
     fused engine against its segment loop on one image (same exit,
     bitwise logits), its launches per image against the routes, and the
     fused p50 of 20 images after 3, early exit and full depth, with
     device ms, host launches and readbacks per image;
  15. spatial sharding and channel tensor parallelism, run before the
     summary: first K3, K4, K5 and K6 each on the window of rows the flat
     DAG's block rule fetches for a band that starts mid-map, at the
     flagship's widths (against the plain versions on the window and the
     whole map's kernel output); then each rank a child process
     (``--sharded-child``), world 1 then world 2: the flagship
     at 1025x2049, batch 1, through spatial_shard_forward
     at world 1 over NCCL (the band is the image) and at world 2 as two
     processes on cuda:0 over gloo (NCCL refuses two ranks on one GPU;
     compute stays on the card, the exchanged rows go through the host),
     xla in fp32 and bf16, then SHARDED_RUNS: flat (fp32, bf16),
     flat-packed with the mixed genotype (fp32: K4 and K6), packed and
     dense-sep (fp32, bf16): each rank's rows against the same
     execution's unsharded forward on the card (SHARDED_TOL of max|ref|),
     exactly one K1 launch a rank an image and the flat runs' K3-K6
     launches against the routes of the cells whose level holds rows on
     the rank, each rank's peak memory beside the unsharded forward's, the
     bytes of rows it received and the p50s of both; then, in the same processes,
     one fp32 step of make_tp_train_step on a 1x1 mesh over NCCL (769x769, batch 4) against
     TrainStep on the same state and batch (PARALLEL_TOL), and on a (1, 2)
     mesh over gloo on cuda:0 at SHARDED_TP_HW, batch 2 (every gather goes
     through the host: the crop is cut for time) held to the
     single-device step by tests/test_tensor_parallel.py's distribution
     criteria, with each rank's state bytes (under 3/4 of the unsharded
     state's), peak memory and step ms beside the single step's;
  16. the JAX package's checkpoints, run before the summary: the port's
     zstd decoder built with g++ (its seconds), the committed JAX run
     directory (tests/torch_orbax_fixture: a stage-2 train state, an EDM
     and a search state, orbax with OCDBT) read three times each (the
     median ms) and every leaf held bitwise to tests/torch_orbax_ref.npz;
     the ADD (C=2, F=4, 19 classes) and its EDM restored on cuda through
     cli.evaluate's build from that directory (--resume, --edm-resume),
     then on the 8 validation images at 65x65 static validation (one K1
     an image and one K2 an exit), the per-exit logits of two images, the
     dynamic segment loop (one K1 an image and one for its warm-up) and the fused engine image by
     image: logits, EDM confidences and exits against the JAX package's
     on the CPU (RESTORE_TOL), and cli.evaluate.main's exit histogram;
     then one train step resumed from the JAX train state on the card and
     on the CPU (batch 4): the loss and the update against JAX's recorded
     step, the card against the CPU;
  9. the kernels summary line; each kernel's launches are those phases 6,
     10 and 12 ran on the card: its wrapper count in the static,
     segment-loop and training runs, and in the fused runs the profiler's
     count of the warm-up and the replays (not the capture, which runs
     nothing); ``train_path_launches`` are phase 10's alone,
     ``search_path_launches`` phase 11's, ``data_path_launches`` phase
     12's, ``parallel_path_launches`` phase 13's, ``variants_path_launches``
     phase 14's, ``sharded_path_launches`` phase 15's,
     ``restore_path_launches`` phase 16's. A run of a subset of the
     phases lists the kernels whose checks (2-4) ran.
The last lines are the kernels summary, the card's name and power limit
from nvidia-smi, and {"ok": true, "device": {...}}. Without a GPU, or
without the port beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak; an fp32 product by 3xTF32 takes three
H100_FP32_FLOPS = 67e12   # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
FULL_HW = (1025, 2049)
# the flagship's DAG widths at 1025x2049: level 1, 2, 3
CELL_SHAPES = ((40, 129, 257), (80, 65, 129), (160, 33, 65))
# the flagship genotype's blocks, in order, then a skip+sep and a one-edge block
CELL_BLOCKS = (
    ("dil_conv_5x5", "sep_conv_3x3"), ("sep_conv_3x3", "dil_conv_3x3"),
    ("sep_conv_3x3", "sep_conv_3x3"), ("sep_conv_5x5", "sep_conv_5x5"),
    ("dil_conv_5x5", "sep_conv_5x5"), ("skip_connect", "sep_conv_3x3"), ("sep_conv_5x5",),
)
# pools, skip and none: max_pool+sep3 (per-op K4), skip+dil5 (K3),
# avg_pool+dil3 (per-op K6), none+sep5 (one-edge K3), skip+sep3 (K3)
MIXED_GENOTYPE = [[0, 1], [1, 4], [2, 3], [3, 7], [5, 2], [8, 6], [11, 0], [13, 5], [18, 3], [19, 4]]
CELL_KERNELS = ("block_stage", "sep_fused", "sep_stage", "dense_stage")
# the --cell-exec values whose cells run K3-K6, and phase 14's variants
FLAT_EXECS = ("flat", "flat-packed")
VARIANTS = ("packed", "flat-packed", "dense-sep")
# the host calls that put work on the card, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# fp32 trained weights: the exit-0 EDM confidence against the JAX-CPU
# oracle; fp32 on the card reads 1.4e-7, bf16 1.8e-4, so a path that ran
# at TF32 or bf16 exceeds it
TRAINED_FP32_CONF_TOL = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, runs: int = 10, tries: int = 10):
    """Mean device time of the kernels one call of ``fn`` launches, by
    torch.profiler: unlike ``cuda_ms``, without the host's share of the
    call. None (not measured) when every one of ``tries`` sessions
    recorded fewer kernels than were launched."""
    fn()
    torch.cuda.synchronize()
    # a profiling session now and then (one in five or six on the H100's
    # machine) records fewer kernels than were launched (one call each at
    # least): such a session is run again
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(kernels) >= runs and len(kernels) % runs == 0:
            return sum(e.time_range.elapsed_us() for e in kernels) / runs / 1e3
    print(f"device_ms: the profiler recorded {len(kernels)} kernels for {runs} calls, {tries} times: "
          "not measured", file=sys.stderr, flush=True)
    return None


def kernels_per_call(fn, runs: int = 10, tries: int = 10):
    """Device kernels (memsets and copies included) that one call of ``fn``
    launches, by torch.profiler: the count over ``runs`` calls divided by
    ``runs``, from the first session whose count is a whole multiple of
    ``runs`` (see ``device_ms``); None (not measured) when none was."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels and len(kernels) % runs == 0:
            return len(kernels) // runs
    return None


def bound(flops: float, nbytes: float, peak_flops: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _conv_out(n: int) -> int:
    return (n - 1) // 2 + 1


def stems_products(n, h, w):
    """FLOP of K1's products: stem0 (27 a pixel and channel), stem1 and stem2."""
    h0, w0 = _conv_out(h), _conv_out(w)
    h1, w1 = _conv_out(h0), _conv_out(w0)
    return 2 * n * ((27 * 64 + 576 * 64) * h0 * w0 + 576 * 128 * h1 * w1)


def stems_bound(n, h, w, in_bytes, out_bytes, dtype):
    """K1 runs every product on the tensor cores (stem0 as one K = 32 step,
    counted at its 27 real products a pixel): the larger of the products
    at the tensor-core rate (bf16, or fp32 by 3xTF32) and the bytes (the
    image read, s0 and s1 written, the packed weights read once)."""
    h0, w0 = _conv_out(h), _conv_out(w)
    h1, w1 = _conv_out(h0), _conv_out(w0)
    weights = out_bytes * (64 * 32 + 9 * 64 * 64 + 9 * 128 * 64) + 4 * (64 + 64 + 128)
    nbytes = n * (h * w * 3 * in_bytes + (h0 * w0 * 64 + h1 * w1 * 128) * out_bytes) + weights
    return cell_ops_bound(0, stems_products(n, h, w), nbytes, dtype)


def entropy_bound(n, c, h, w, in_bytes):
    # per pixel and class: subtract, exp, add, multiply-add; log + divide per pixel
    flops = n * h * w * (5 * c + 4)
    nbytes = n * h * w * (c * in_bytes + 4)
    return bound(flops, nbytes, H100_FP32_FLOPS)


def _edge_flops(name, c):
    """(FLOP on the CUDA cores, FLOP of products) a pixel of one primitive
    at C in = C out, a multiply-add counting 2: depthwise taps and pools on
    the CUDA cores in fp32, pointwise and dense products on the tensor cores."""
    if name.startswith("sep_conv"):
        k = int(name[-1])
        return 2 * 2 * k * k * c, 2 * 2 * c * c
    if name.startswith("dil_conv"):
        k = int(name[-1])
        return 0, 2 * k * k * c * c
    return (9 * c if name.endswith("pool_3x3") else 0), 0


def _block_flops(names, c):
    """(CUDA-core, product) FLOP a pixel of one block: its edges plus one
    add a value for each extra edge."""
    cuda = sum(_edge_flops(nm, c)[0] for nm in names) + c * (len(names) - 1)
    return cuda, sum(_edge_flops(nm, c)[1] for nm in names)


def cell_ops_bound(cuda_flops, product_flops, nbytes, dtype):
    """(ms, 'operations' | 'bytes'): the least time of cell work, the
    larger of the CUDA cores' time (fp32 rate), the tensor cores' (bf16, or
    fp32 by 3xTF32 at a third of the TF32 rate; the two units may run at
    once) and the bytes' time."""
    tc = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_TF32_FLOPS / 3
    t_ops = max(cuda_flops / H100_FP32_FLOPS, product_flops / tc)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cell_bound(names, c, h, w, n_sources, dtype):
    """One block (or one op, with one name); each distinct source read
    once, the output written once."""
    eb = torch.finfo(dtype).bits // 8
    cuda, product = _block_flops(names, c)
    return cell_ops_bound(h * w * cuda, h * w * product, (n_sources + 1) * h * w * c * eb, dtype)


def stage_bound(k, c, h, w, dtype):
    """One dw k x k -> pw stage (K5)."""
    eb = torch.finfo(dtype).bits // 8
    return cell_ops_bound(h * w * 2 * k * k * c, h * w * 2 * c * c, 2 * h * w * c * eb, dtype)


def dag_totals(genotype, dtype):
    """CUDA-core FLOP, product FLOP and bytes of the 12 cells' DAGs of the
    flagship at 1025x2049."""
    from auto_dynamic_deeplab_torch.kernels.cell_ops import PRIMITIVES, dag_blocks
    from auto_dynamic_deeplab_torch.models.cell import as_genotype_rows, edge_op_assignment
    from auto_dynamic_deeplab_torch.nas import NETWORK_ARCH

    eb = torch.finfo(dtype).bits // 8
    blocks = dag_blocks(edge_op_assignment(as_genotype_rows(genotype)), 5)
    cuda = product = nbytes = 0
    for level in NETWORK_ARCH[2]["path"]:
        c, h, w = CELL_SHAPES[level - 1]
        for rows in blocks:
            bc, bp = _block_flops([PRIMITIVES[p] for _, _, p in rows], c)
            cuda, product = cuda + h * w * bc, product + h * w * bp
            nbytes += (len({j for j, _, _ in rows}) + 1) * h * w * c * eb
    return cuda, product, nbytes


def _cell_fns():
    from auto_dynamic_deeplab_torch.kernels import cell_ops

    return {name: getattr(cell_ops, name) for name in CELL_KERNELS}


def _all_kernels():
    from auto_dynamic_deeplab_torch.kernels.confidence import entropy_argmax_triton
    from auto_dynamic_deeplab_torch.kernels.stems import fused_stems

    return {"fused_stems": fused_stems, "entropy_argmax_triton": entropy_argmax_triton, **_cell_fns()}


def expected_cell_launches(genotype, dtype, cells):
    """K3-K6 launches of the flagship's cells ``cells`` under ``genotype``."""
    from auto_dynamic_deeplab_torch.kernels.cell_ops import dag_launches
    from auto_dynamic_deeplab_torch.models.cell import as_genotype_rows, edge_op_assignment
    from auto_dynamic_deeplab_torch.nas import NETWORK_ARCH

    assignment = edge_op_assignment(as_genotype_rows(genotype))
    path = NETWORK_ARCH[2]["path"]
    total = Counter()
    for i in cells:
        total += dag_launches(assignment, 5, CELL_SHAPES[path[i] - 1][0], dtype)
    return total


# ------------------------------------------------------------------ phases


def phase_device(ctx):
    from auto_dynamic_deeplab_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
    ctx["smi"] = nvidia_smi_line()
    emit({
        "phase": "device", "nvidia_smi": ctx["smi"],
        "torch_device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_build_s": build_s, "ptxas": ptxas,
    })


def phase_k1(ctx):
    from auto_dynamic_deeplab_torch.kernels import stems as k1
    from auto_dynamic_deeplab_torch.models.decoded import _Stems
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator().manual_seed(0)
        stems = randomize_bn(init_params(_Stems(dtype), g), g).cuda().eval()
        for hw, n in ((FULL_HW, 1), ((65, 97), 1), ((66, 98), 1), ((257, 513), 2), ((135, 263), 2)):
            x = torch.randn(n, *hw, 3, generator=g).cuda().permute(0, 3, 1, 2)
            with torch.inference_mode():
                outs = stems(x)
                refs = k1.stems_reference(stems, x)
                torch.cuda.synchronize()
                abs_err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
                rel = max(
                    ((o.float() - r.float()).abs().max() / r.float().abs().max()).item()
                    for o, r in zip(outs, refs)
                )
                if not rel <= tol:
                    raise AssertionError(f"K1 {dtype} {hw} n={n}: relative error {rel} > {tol}")
                row = {"dtype": str(dtype).split(".")[-1], "hw": list(hw), "n": n,
                       "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": tol}
                plan = k1.plan_stems(dtype, hw, n)
                row.update(tile=list(plan.tile), smem=plan.smem, resident=plan.resident,
                           blocks=k1.stem_blocks(plan.tile, n, *hw))
                if hw == FULL_HW:
                    weights = k1.stem_weights(stems, dtype)
                    fn = lambda: k1.fused_stems(x, weights, dtype)  # noqa: E731
                    row["ms"] = cuda_ms(fn)
                    row["device_ms"] = device_ms(fn)
                    row["plain_ms"] = cuda_ms(lambda: k1.stems_reference(stems, x))
                    row["library_ms"] = None  # no single PyTorch call: three convs with BN
                    row["bound_ms"], row["bound_by"] = stems_bound(
                        n, *hw, 4, torch.finfo(dtype).bits // 8, dtype
                    )
                    gflop = stems_products(n, *hw) / 1e9
                    row["tflops"] = gflop / row["ms"]
                    row["device_tflops"] = gflop / row["device_ms"] if row["device_ms"] else None
                    row["nvidia_smi"] = nvidia_smi_line()
                    ctx.setdefault("k1", {})[row["dtype"]] = row
            rows.append(row)
    emit({"phase": "k1_stems", "checks": rows})


def phase_k2(ctx):
    from auto_dynamic_deeplab_torch.kernels.confidence import (
        entropy_argmax_reference,
        entropy_argmax_triton,
    )

    rows = []
    g = torch.Generator().manual_seed(1)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        cases = [
            ("channels_last", (1, 19, *FULL_HW)), ("nchw", (1, 19, *FULL_HW)),
            ("nhwc", (1, 19, *FULL_HW)), ("nchw", (3, 19, 65, 97)),
        ]
        for layout, shape in cases:
            x = (torch.randn(*shape, generator=g) * 3).cuda()
            axis = 1
            if layout == "nhwc":
                x, axis = x.permute(0, 2, 3, 1).contiguous(), -1
            elif layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            x = x.to(dtype)
            ent, arg = entropy_argmax_triton(x, 19, class_axis=axis)
            ent_r, arg_r = entropy_argmax_reference(x, 19, class_axis=axis)
            torch.cuda.synchronize()
            err = (ent - ent_r).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"K2 {dtype} {layout} {shape}: entropy error {err} > {tol}")
            if not torch.equal(arg, arg_r):
                raise AssertionError(f"K2 {dtype} {layout} {shape}: argmax differs")
            row = {"dtype": str(dtype).split(".")[-1], "layout": layout, "shape": list(shape),
                   "max_abs_err": err, "tol": tol, "argmax_equal": True}
            fn = lambda: entropy_argmax_triton(x, 19, class_axis=axis)  # noqa: E731
            # repeated calls: bitwise the same (at N=3 this also checks that
            # each launch leaves its images' counters at 0 for the next)
            for _ in range(2):
                again = fn()
                if not (torch.equal(again[0], ent) and torch.equal(again[1], arg)):
                    raise AssertionError(f"K2 {dtype} {layout} {shape}: a repeated call differs")
            row["repeat_bitwise_equal"] = True
            if shape[0] == 1:
                row["ms"] = cuda_ms(fn)
                row["device_ms"] = device_ms(fn)
                row["device_kernels_per_call"] = kernels_per_call(fn)
                if row["device_kernels_per_call"] != 1:
                    raise AssertionError(f"K2 {dtype} {layout}: {row['device_kernels_per_call']} device "
                                         "kernels a call, want 1")
                row["plain_ms"] = cuda_ms(lambda: entropy_argmax_reference(x, 19, class_axis=axis))
                row["bound_ms"], row["bound_by"] = entropy_bound(
                    1, 19, *FULL_HW, torch.finfo(dtype).bits // 8
                )
                # the decoder hands K2 (N, C, H, W)-contiguous logits
                if layout == "nchw":
                    ctx.setdefault("k2", {})[row["dtype"]] = row
            rows.append(row)
    emit({"phase": "k2_entropy_argmax", "checks": rows})


def _measure(fn, ref, tol, what, lib=None):
    """Check ``fn`` (a kernel) against ``ref`` (its plain version) on the
    card, relative to max|ref|, then time both (and ``lib``, a yardstick)."""
    with torch.inference_mode():
        out, want = fn(), ref()
        torch.cuda.synchronize()
        abs_err = (out.float() - want.float()).abs().max().item()
        ref_max = want.float().abs().max().item()
        rel = abs_err / ref_max if ref_max > 0 else float("inf")  # two zero outputs prove nothing
        if not rel <= tol:
            raise AssertionError(f"{what}: relative error {rel} > {tol} (max|ref| {ref_max})")
        row = {"max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": tol, "max_abs_ref": ref_max,
               "ms": cuda_ms(fn, runs=10), "plain_ms": cuda_ms(ref, runs=10),
               "library_ms": None if lib is None else cuda_ms(lib, runs=10)}
    return row


def phase_cells(ctx):
    import torch.nn.functional as F

    from auto_dynamic_deeplab_torch.kernels import cell_ops as co
    from auto_dynamic_deeplab_torch.ops.primitives import OPS
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()

    def op(name, c, seed):
        g = torch.Generator().manual_seed(seed)
        return randomize_bn(init_params(OPS[name](c, 1), g), g).cuda().eval()

    def state(c, h, w, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(1, h, w, c, generator=g).cuda().to(dtype).permute(0, 3, 1, 2)

    rows, routes, keyed = [], {}, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        dname = str(dtype).split(".")[-1]
        for c, h, w in CELL_SHAPES:
            xs = [state(c, h, w, dtype, seed) for seed in (0, 1)]
            for bi, names in enumerate(CELL_BLOCKS):
                route = co.block_route(names, c, dtype)
                routes[f"{dname} C={c} {'+'.join(names)}"] = list(route)
                if route != ("block_stage",):
                    continue
                edges = [(xs[i], nm, co.edge_weights(op(nm, c, 10 * bi + i), nm, dtype)
                          if nm != "skip_connect" else None) for i, nm in enumerate(names)]
                fn = lambda: co.block_stage(edges)  # noqa: E731
                row = _measure(fn, lambda: co.block_stage_reference(edges), tol, f"K3 {dname} C={c} {names}")
                row["bound_ms"], row["bound_by"] = cell_bound(names, c, h, w, len(names), dtype)
                plan = co.plan_block(names, c, dtype, (h, w), 1)
                with torch.inference_mode():
                    dev = device_ms(fn)
                gflop = h * w * sum(_block_flops(names, c)) / 1e9
                row.update(kernel="block_stage", dtype=dname, shape=[c, h, w], edges=list(names),
                           tile=list(plan.tile), ns=plan.ns, slices=-(-c // 8) * 8 // plan.ns, ng=plan.ng,
                           blocks=co.dense_blocks(plan, c, 1, h, w), device_ms=dev,
                           device_tflops=gflop / dev if dev else None)
                rows.append(row)
            flagship = [r for r in rows if r["kernel"] == "block_stage" and r["dtype"] == dname
                        and r["shape"][0] == c and tuple(r["edges"]) in CELL_BLOCKS[:5]]
            dev = [r["device_ms"] for r in flagship]
            emit({"phase": "k3_per_cell", "dtype": dname, "shape": [c, h, w], "k3_blocks": len(flagship),
                  "ms": sum(r["ms"] for r in flagship), "device_ms": None if None in dev else sum(dev),
                  "nvidia_smi": ctx["smi"]})
            for ni, name in enumerate(("sep_conv_3x3", "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5")):
                x, k = xs[0], int(name[-1])
                wts = co.edge_weights(op(name, c, 100 + ni), name, dtype)
                checks = []
                if name.startswith("dil"):
                    qd = wts.q[:, :, :c].reshape(k, k, c, c).permute(3, 2, 0, 1).contiguous()
                    bd = wts.bias[:c].to(dtype)
                    lib = lambda: F.conv2d(F.relu(x), qd, bd, dilation=2, padding=2 * (k // 2))  # noqa: E731
                    checks.append(("dense_stage", co.plan_dense_stage(name, c, dtype, (h, w), 1),
                                   lambda: co.dense_stage(x, name, wts),
                                   lambda: co.dense_stage_reference(x, wts), lib,
                                   cell_bound([name], c, h, w, 1, dtype)))
                else:
                    mid = co.sep_stage_reference(x, wts[0], True, True)
                    checks += [
                        ("sep_fused", co.plan_sep_fused(name, c, dtype, (h, w), 1), lambda: co.sep_fused(x, name, wts),
                         lambda: co.sep_fused_reference(x, *wts), None,
                         cell_bound([name], c, h, w, 1, dtype)),
                        ("sep_stage", co.plan_sep_stage(name, c, dtype, (h, w), 1),
                         lambda: co.sep_stage(x, name, wts[0], True, True),
                         lambda: co.sep_stage_reference(x, wts[0], True, True), None,
                         stage_bound(k, c, h, w, dtype)),
                        ("sep_stage", co.plan_sep_stage(name, c, dtype, (h, w), 1),
                         lambda: co.sep_stage(mid, name, wts[1], False, False),
                         lambda: co.sep_stage_reference(mid, wts[1], False, False), None,
                         stage_bound(k, c, h, w, dtype)),
                    ]
                for kernel, plan, fn, ref, lib, (bms, bby) in checks:
                    if plan is None:
                        routes[f"{dname} C={c} {name} {kernel}"] = "no tile fits"
                        continue
                    row = _measure(fn, ref, tol, f"{kernel} {dname} C={c} {name}", lib)
                    row.update(kernel=kernel, dtype=dname, shape=[c, h, w], op=name, tile=list(plan.tile),
                               bound_ms=bms, bound_by=bby)
                    with torch.inference_mode():
                        dev = device_ms(fn)
                        if lib is not None:
                            row["library_device_ms"] = device_ms(lib)
                    # one K5 pass is one of a SepConv's two stages
                    gflop = h * w * sum(_edge_flops(name, c)) / 1e9 / (2 if kernel == "sep_stage" else 1)
                    row.update(blocks=co.dense_blocks(plan, c, 1, h, w), n_split=-(-c // 8) * 8 // plan.ns,
                               ns=plan.ns, ng=plan.ng, tflops=gflop / row["ms"], device_ms=dev,
                               device_tflops=gflop / dev if dev else None)
                    rows.append(row)
    for row in rows:
        emit({"phase": "cell_kernels", **row})
    emit({"phase": "cell_routes", "routes": routes})

    # summary rows, in the dtype of the main path (fp32) with bf16 beside
    # it: K3 the widest level-1 block; K4 the mixed genotype's level-1 sep3;
    # K5 and K6 the flagship's level-3 per-op sep5 (stage 1) and dil5
    def pick(kernel, c, dname, **match):
        for row in rows:
            if row["kernel"] == kernel and row["shape"][0] == c and row["dtype"] == dname and all(
                    row.get(k) == v for k, v in match.items()):
                return row
        raise AssertionError(f"no {kernel} row at C={c} {dname} {match}")

    for dname in ("float32", "bfloat16"):
        keyed.setdefault("block_stage", {})[dname] = pick("block_stage", 40, dname,
                                                          edges=["dil_conv_5x5", "sep_conv_5x5"])
        keyed.setdefault("sep_fused", {})[dname] = pick("sep_fused", 40, dname, op="sep_conv_3x3")
        keyed.setdefault("sep_stage", {})[dname] = pick("sep_stage", 160, dname, op="sep_conv_5x5")
        keyed.setdefault("dense_stage", {})[dname] = pick("dense_stage", 160, dname, op="dil_conv_5x5")
    ctx["cells"] = keyed
    for dtype in (torch.float32, torch.bfloat16):
        cuda, product, nbytes = dag_totals(_flagship_genotype(), dtype)
        ms, by = cell_ops_bound(cuda, product, nbytes, dtype)
        emit({"phase": "flagship_dag_bound", "dtype": str(dtype).split(".")[-1], "cells": 12,
              "cuda_core_gflop": cuda / 1e9, "product_gflop": product / 1e9, "gbytes": nbytes / 1e9,
              "bound_ms": ms, "bound_by": by})


def _flagship_genotype():
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE

    return AUTODEEPLAB_GENOTYPE


def _flagship(dtype=None, seed=0, flat_eval=False, genotype=None, **flags):
    """The flagship ADD with seeded weights; the same seed gives the same
    weights with any cell execution (``flags``: ``packed_eval``,
    ``dense_sep_eval``); ``genotype`` replaces the flagship's cells."""
    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE if genotype is None else genotype, 19, F=20, B=5,
                low_level_layer=cfg["low_level_layer"], dtype=dtype, flat_eval=flat_eval, **flags)
    g = torch.Generator().manual_seed(seed)
    return randomize_bn(init_params(model, g), g).eval()


def phase_model(ctx):
    import copy

    from auto_dynamic_deeplab_torch.runtime import resolve_device

    dev = resolve_device("cuda")  # TF32 off (runtime.ALLOW_TF32)
    cpu_model = _flagship()
    x = torch.randn(1, 129, 257, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        refs = cpu_model(x, class_leading=True)
    for cell_exec, gpu_model in (("xla", copy.deepcopy(cpu_model).to(dev)),
                                 ("flat", _flagship(flat_eval=True).to(dev))):
        fns = _cell_fns()
        for f in fns.values():
            f.launches = 0
        with torch.inference_mode():
            outs = gpu_model(x.to(dev), class_leading=True)
        rows = []
        for o, r in zip(outs, refs):
            o = o.float().cpu()
            err = (o - r).abs().max().item()
            tol = 1e-3 * r.abs().max().item()
            if not (torch.isfinite(o).all() and err <= tol):
                raise AssertionError(f"{cell_exec} flagship logits on the card differ from the CPU: "
                                     f"{err} > {tol}")
            rows.append({"shape": list(o.shape), "max_abs_err": err, "tol": tol})
        if not outs[0].is_contiguous():
            raise AssertionError("class-leading logits should be (N, C, H, W)-contiguous for K2")
        launches = {name: f.launches for name, f in fns.items()}
        if cell_exec == "flat" and launches["block_stage"] == 0:
            raise AssertionError(f"the flat flagship launched no block kernel: {launches}")
        emit({"phase": "flagship_fp32_card_vs_cpu", "cell_exec": cell_exec, "hw": [129, 257],
              "exits": rows, "cell_launches": launches})


def _device_kernel_counts(fn, runs_ok, tries: int = 5):
    """(result of ``fn``, the port's device kernels it launched by name) by
    torch.profiler. A session now and then records fewer kernels than were
    launched (see ``device_ms``), so a session whose counts ``runs_ok``
    rejects as too few is run again, up to ``tries`` sessions; the last
    counts are returned either way and the caller checks them. Each
    session starts with one small kernel of its own, which is not counted:
    the first kernel a session sees is the one most often lost."""
    from auto_dynamic_deeplab_torch.kernels import count_device_kernels

    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        counts = count_device_kernels(
            e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if runs_ok(counts):
            break
        print(f"a profiler session recorded too few kernels: {counts}; run again", file=sys.stderr, flush=True)
    return out, counts


def _as_device(wrapper_counts) -> dict:
    """Wrapper launches as device kernel counts (K3 and K4 launch one kernel)."""
    from auto_dynamic_deeplab_torch.kernels import DEVICE_KERNELS

    out = Counter()
    for name, v in wrapper_counts.items():
        out[DEVICE_KERNELS[name]] += v
    return {k: out.get(k, 0) for k in sorted(set(DEVICE_KERNELS.values()))}


def _check_run(name, cell_exec, stats, counts, n_img, genotype):
    """The wrapper launches of one static or segment-loop run against what
    it must show."""
    k1, k2 = counts["fused_stems"], counts["entropy_argmax_triton"]
    want_k1 = n_img if name == "static" else n_img + 1  # a dynamic run's warm-up runs the stems once
    if k1 != want_k1:
        raise AssertionError(f"{name} {cell_exec}: K1 launched {k1} times for {n_img} images "
                             f"(batch 1), want {want_k1}")
    if name == "static":
        if k2 < 2 * n_img:
            raise AssertionError(f"static {cell_exec}: K2 launched {k2} times, want >= {2 * n_img}")
        if not all(0.0 <= m <= 1.0 for m in stats["miou"]):
            raise AssertionError(f"static mIoU out of range: {stats['miou']}")
    else:
        _check_dynamic_stats(name, cell_exec, stats, n_img)
        if name.startswith("dynamic_entropy") and k2 < n_img:
            raise AssertionError(f"{name} {cell_exec}: K2 launched {k2} times for {n_img} images")
    cells = {k: counts[k] for k in CELL_KERNELS}
    if cell_exec not in FLAT_EXECS:
        if any(cells.values()):
            raise AssertionError(f"{name}: the {cell_exec} path launched cell kernels {cells}")
        return
    # per image: cells 0-5 when it exits at exit 0, all 12 at full depth;
    # a dynamic run's warm-up runs every cell once; validate runs all 12
    early = expected_cell_launches(genotype, torch.float32, range(6))
    full = expected_cell_launches(genotype, torch.float32, range(12))
    if name == "static":
        want = Counter({k: n_img * v for k, v in full.items()})
    else:
        hist = stats["exit_histogram"]
        want = Counter({k: v * (1 + hist[1]) for k, v in full.items()})
        want.update({k: v * hist[0] for k, v in early.items()})
    want = {k: want.get(k, 0) for k in CELL_KERNELS}
    if cells != want:
        raise AssertionError(f"{name} {cell_exec}: cell kernel launches {cells}, the routes predict {want}")


def _check_dynamic_stats(name, cell_exec, stats, n_img):
    if not (0.0 <= stats["miou"] <= 1.0 and stats["mean_latency_s"] > 0 and stats["n_images"] == n_img):
        raise AssertionError(f"{name} {cell_exec}: bad stats {stats}")
    want = {"dynamic_entropy_thr0": [0, n_img], "dynamic_entropy_thr1.01": [n_img, 0]}
    if name in want and stats["exit_histogram"] != want[name]:
        raise AssertionError(f"{name} {cell_exec}: exit histogram {stats['exit_histogram']}")


def _fused_wants(name, cell_exec, stats, genotype):
    """(wrapper counts, the launches that may be right) of one fused
    dynamic run; each launch count is a pair (by wrapper, by device
    kernel). The warm-up runs every segment once eagerly and the capture
    calls every wrapper once more, launching nothing; the device sees the
    warm-up and every replay: each image's segments, the first image's
    twice (its first, capture-inclusive timing is discarded). The first
    image's exit is the histogram's only one, or else either."""
    conf = "edm" if name == "dynamic_edm" else "entropy"
    hist, n_img = stats["exit_histogram"], stats["n_images"]
    cells = CELL_KERNELS if cell_exec in FLAT_EXECS else ()
    early, full = (expected_cell_launches(genotype, torch.float32, range(c)) for c in (6, 12))
    segments = Counter({"fused_stems": 1, "entropy_argmax_triton": int(conf == "entropy")})
    segments.update({k: v for k, v in full.items() if k in cells})
    wrappers = Counter({k: 2 * v for k, v in segments.items()})
    wrappers = {k: wrappers.get(k, 0) for k in ("fused_stems", "entropy_argmax_triton", *CELL_KERNELS)}
    per_exit = [Counter({"fused_stems": 1, "entropy_argmax_triton": int(conf == "entropy")}) for _ in hist]
    for c, per in zip((early, full), per_exit):
        per.update({k: v for k, v in c.items() if k in cells})
    devices = []
    for first in [k for k, h in enumerate(hist) if h]:
        dev = Counter(segments)
        for k, h in enumerate(hist):
            for _ in range(h + int(k == first)):
                dev.update(per_exit[k])
        devices.append(({k: dev.get(k, 0) for k in wrappers}, _as_device(dev)))
    return wrappers, devices


def _fused_cli_run(kernels, name, cell_exec, main, genotype, n_img=8, phase="main_path"):
    """One ``cli.evaluate --dynamic`` run (the fused graphs) by ``main``:
    its wrapper calls (the warm-up and the capture) and the device kernels
    the profiler counts (the warm-up and every replay) against what the
    routes predict. Returns (stats, the launches that ran, by wrapper)."""
    seen = {}

    def enough(device):
        _, wants = _fused_wants(name, cell_exec, seen["stats"], genotype)
        return any(all(device[k] >= w[k] for k in w) for _, w in wants)

    def run():
        for f in kernels.values():
            f.launches = 0
        stats = main()
        seen.update(stats=stats, counts={n: f.launches for n, f in kernels.items()})
        return stats

    stats, device = _device_kernel_counts(run, enough)
    counts = seen["counts"]
    _check_dynamic_stats(name, cell_exec, stats, n_img)
    wrappers, wants = _fused_wants(name, cell_exec, stats, genotype)
    if counts != wrappers:
        raise AssertionError(f"{name} {cell_exec} fused: wrapper calls {counts}, the warm-up and "
                             f"the capture predict {wrappers}")
    ran = [by_wrapper for by_wrapper, by_kernel in wants if by_kernel == device]
    if not ran:
        raise AssertionError(f"{name} {cell_exec} fused: device kernels {device}, the routes "
                             f"predict one of {[w for _, w in wants]}")
    # what ran on the device (warm-up and replays), by wrapper
    emit({"phase": phase, "cell_exec": cell_exec, "run": name, "mode": "fused",
          "stats": stats, "launches": ran[0], "wrapper_calls": counts, "device_kernels": device})
    return stats, ran[0]


def phase_main_path(ctx):
    from auto_dynamic_deeplab_torch.cli import evaluate

    kernels = _all_kernels()
    base = ["--dataset", "synthetic", "--synthetic-crop", str(FULL_HW[0]), str(FULL_HW[1]),
            "--synthetic-length", "32", "--workers", "4"]
    runs = [
        ("static", []),
        ("dynamic_entropy_thr0", ["--dynamic", "--confidence", "entropy", "--threshold", "0"]),
        ("dynamic_entropy_thr1.01", ["--dynamic", "--confidence", "entropy", "--threshold", "1.01"]),
        ("dynamic_edm", ["--dynamic", "--confidence", "edm"]),
    ]
    total = Counter()

    def drive(fn):
        for f in kernels.values():
            f.launches = 0
        stats = fn()
        return stats, {name: f.launches for name, f in kernels.items()}

    genotype = _flagship_genotype()
    for cell_exec in ("xla", "flat"):
        for name, extra in runs:
            argv = base + ["--cell-exec", cell_exec] + extra
            if name == "static":
                stats, counts = drive(lambda: evaluate.main(argv))
                _check_run(name, cell_exec, stats, counts, 8, genotype)  # the 8-image val set
                emit({"phase": "main_path", "cell_exec": cell_exec, "run": name, "stats": stats,
                      "launches": counts})
                total.update(counts)
                continue
            # the fused (graph) run; the device counts the replays' kernels
            stats, ran = _fused_cli_run(kernels, name, cell_exec, lambda: evaluate.main(argv), genotype)
            total.update(ran)
        # the segment loop (fused=False) through the CLI's own build
        name = "dynamic_entropy_thr0"
        args = evaluate.build_parser().parse_args(base + ["--cell-exec", cell_exec] + runs[1][1])
        evaluation, loader = evaluate.build(args)
        stats, counts = drive(lambda: evaluation.dynamic_inference(
            loader, threshold=0.0, confidence="entropy", warmup_shape=(1, *FULL_HW, 3), fused=False))
        _check_run(name, cell_exec, stats, counts, stats["n_images"], genotype)
        emit({"phase": "main_path", "cell_exec": cell_exec, "run": name, "mode": "segment_loop",
              "stats": stats, "launches": counts})
        total.update(counts)
        del evaluation
    with tempfile.TemporaryDirectory() as tmp:
        geno = Path(tmp) / "mixed_genotype.npy"
        np.save(geno, np.array(MIXED_GENOTYPE, dtype=np.int64))
        stats, counts = drive(lambda: evaluate.main(base + ["--cell-exec", "flat", "--genotype", str(geno)]))
    _check_run("static", "flat", stats, counts, 8, MIXED_GENOTYPE)
    for name in ("sep_fused", "dense_stage"):
        if counts[name] == 0:
            raise AssertionError(f"the mixed genotype run launched no {name}: {counts}")
    emit({"phase": "main_path", "cell_exec": "flat", "run": "static_mixed_genotype",
          "genotype": MIXED_GENOTYPE, "stats": stats, "launches": counts})
    total.update(counts)
    missing = [name for name in kernels if total[name] == 0]
    if missing:
        raise AssertionError(f"kernels of the main paths never launched: {missing} ({dict(total)})")
    ctx["launches"] = dict(total)


def _flagship_edm(model, dtype=None, seed=0):
    from auto_dynamic_deeplab_torch.models import EDM
    from auto_dynamic_deeplab_torch.utils.initialize import init_params

    return init_params(EDM(model.feature_channels(model.exit_layers[0]), dtype=dtype),
                       torch.Generator().manual_seed(seed))


def _window(engine, fn, xs, thr):
    """Host launches, readbacks, device ms, busy share and peak memory
    over a profiled run of ``fn`` on the images ``xs``, all counted by
    torch.profiler in both modes: host launches are the runtime and driver
    calls that put work on the card (``HOST_LAUNCH_CALLS``, by name),
    readbacks the scalar reads (``aten::_local_scalar_dense``). The busy
    share is the ms of device kernels over the window's wall ms (the
    kernels of one stream do not overlap); the profiler's own host work is
    in that wall time, so the phase also gives the device ms over the
    unprofiled p50."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays = engine.replays
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for x in xs:
            fn(x, thr, "entropy")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    host = Counter(e.name for e in events if e.name in HOST_LAUNCH_CALLS)
    n = len(xs)
    return {"device_kernels_per_image": len(kernels) / n, "device_ms_per_image": device / n,
            "device_busy_share_profiled": device / wall_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "host_launches_per_image": sum(host.values()) / n,
            "host_launches_by_call": {k: v / n for k, v in sorted(host.items())},
            "readbacks_per_image": sum(e.name == "aten::_local_scalar_dense" for e in events) / n,
            "graph_replays_per_image": (engine.replays - replays) / n}


def _segments(dtype, cell_exec, cells):
    """Wrapper launches of one entropy decide_0 (cells 0-5) or of every
    segment (12 cells)."""
    c = Counter({"fused_stems": 1, "entropy_argmax_triton": 1})
    if cell_exec in FLAT_EXECS:
        c.update(expected_cell_launches(_flagship_genotype(), dtype, range(cells)))
    return c


def _graph_kernels():
    """Prints, as one JSON line, the port's device kernels that torch.profiler
    records over a fresh engine's warm-up (every segment once), capture
    (nothing runs) and two replays (an early exit, then full depth), for
    each dtype and cell execution of phase 7. Run in a process of its own:
    in the process that has run phases 2-6, sessions on the card lost the
    first kernel of a replayed graph (K1) in some calls, though the
    replay's logits were bitwise those of the segment loop; in a fresh
    process no session did."""
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    dev = resolve_device("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for cell_exec in ("xla", "flat"):
            model = _flagship(dtype, flat_eval=cell_exec == "flat").to(dev)
            x = torch.randn((1, *FULL_HW, 3), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
            DynamicInferenceEngine(model, num_classes=19).warmup(x.shape, "entropy", 0.0)  # builds the kernels
            want = _as_device(_segments(dtype, cell_exec, 12) + _segments(dtype, cell_exec, 6)
                              + _segments(dtype, cell_exec, 12))

            def capture_and_replay():
                fresh = DynamicInferenceEngine(model, num_classes=19)  # noqa: B023
                fresh.infer_fused(x, 1.01, "entropy")  # noqa: B023
                fresh.infer_fused(x, 0.0, "entropy")  # noqa: B023

            _, counts = _device_kernel_counts(capture_and_replay,
                                              lambda c: all(c[k] >= v for k, v in want.items()))  # noqa: B023
            out[f"{str(dtype).split('.')[-1]} {cell_exec}"] = counts
            del model
    print(json.dumps(out), flush=True)


def phase_engine(ctx):
    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke._graph_kernels()"],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the graph kernel count failed:\n{res.stderr[-4000:]}")
    ctx["graph_kernels"] = json.loads(res.stdout.strip().splitlines()[-1])
    sys.stderr.write("".join(ln + "\n" for ln in res.stderr.splitlines() if "too few" in ln))
    for dtype in (torch.float32, torch.bfloat16):
        for cell_exec in ("xla", "flat"):
            _engine_modes(ctx, dtype, cell_exec)
            gc.collect()  # the engine's graphs and their pool go with it
            torch.cuda.empty_cache()


def _engine_modes(ctx, dtype, cell_exec):
    """Phase 7 for one dtype and cell execution."""
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    dev = resolve_device("cuda")
    shape = (1, *FULL_HW, 3)
    fns, kernels = _cell_fns(), _all_kernels()
    dname = str(dtype).split(".")[-1]
    model = _flagship(dtype, flat_eval=cell_exec == "flat").to(dev)
    engine = DynamicInferenceEngine(model, edm=_flagship_edm(model, dtype), num_classes=19)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(shape, generator=g, device=dev)
    engine.warmup(shape, "entropy", 0.0)
    # the segment loop's window before any graph holds memory
    xs = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
    windows = {}
    for thr in (1.01, 0.0):
        windows[("segment_loop", thr)] = _window(engine, engine.infer, xs, thr)
    # fused against the segment loop, bitwise; a new threshold captures nothing
    checks = []
    for conf, thrs in (("entropy", (0.0, 1.01)), ("max", (0.05, 0.999)), ("edm", (-1e9, 1e9))):
        before = engine.captures
        for i, thr in enumerate(thrs):
            want, k_want, _, c_want = engine.infer(x, thr, conf)
            got, k_got, _, c_got = engine.infer_fused(x, thr, conf)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            if not (k_got == k_want and c_got == c_want and equal):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"{dname} {cell_exec} {conf} thr={thr}: fused exit {k_got} conf "
                                     f"{c_got}, segment loop exit {k_want} conf {c_want}, "
                                     f"logits max |diff| {diff}")
            if i == 0:
                captured = engine.captures - before
            elif engine.captures != before + captured:
                raise AssertionError(f"{dname} {cell_exec} {conf}: threshold {thr} captured "
                                     f"{engine.captures - before - captured} more graphs")
            checks.append({"confidence": conf, "threshold": thr, "exit": k_got,
                           "confidence_value": c_got, "bitwise_equal": equal})
        want_graphs = 3 if conf == "edm" else 2
        if captured != want_graphs:
            raise AssertionError(f"{dname} {cell_exec} {conf}: {captured} graphs, want {want_graphs}")
    for thr in (1.01, 0.0):
        windows[("fused", thr)] = _window(engine, engine.infer_fused, xs, thr)
    # the replays' kernels, by the profiler, in a fresh process (see
    # ``_graph_kernels``), against the routes
    want = _as_device(_segments(dtype, cell_exec, 12) + _segments(dtype, cell_exec, 6)
                      + _segments(dtype, cell_exec, 12))
    graph_kernels = ctx["graph_kernels"][f"{dname} {cell_exec}"]
    if graph_kernels != want:
        raise AssertionError(f"{dname} {cell_exec} fused: warm-up, capture and two replays launched "
                             f"{graph_kernels}, the routes predict {want}")
    # p50s: segment loop, fused, fused, segment loop
    latency = {}
    for name, thr, want_exit in (("early_exit", 1.01, 0), ("full_depth", 0.0, 1)):
        lat = {"segment_loop": [], "fused": []}
        blocks = {"segment_loop": [], "fused": []}
        per_image = None
        for mode in ("segment_loop", "fused", "fused", "segment_loop"):
            fn = engine.infer if mode == "segment_loop" else engine.infer_fused
            for f in kernels.values():
                f.launches = 0
            block = []
            for _ in range(3 + 20):
                xi = torch.randn(shape, generator=g, device=dev)
                logits, k, dt, _ = fn(xi, thr, "entropy")
                if k != want_exit or not torch.isfinite(logits).all():
                    raise AssertionError(f"{dname} {cell_exec} {mode} {name}: exit {k}, "
                                         f"finite={bool(torch.isfinite(logits).all())}")
                block.append(dt * 1e3)
            lat[mode] += block[3:]
            blocks[mode].append(statistics.median(block[3:]))
            if mode == "segment_loop":
                per_image = {n: f.launches / 23 for n, f in fns.items()}
                want = expected_cell_launches(_flagship_genotype(), dtype, range(6 if want_exit == 0 else 12))
                if cell_exec == "flat" and per_image != {n: float(want.get(n, 0)) for n in fns}:
                    raise AssertionError(f"flat {dname} {name}: cell launches per image {per_image}, "
                                         f"routes predict {dict(want)}")
            elif any(f.launches for f in kernels.values()):
                raise AssertionError(f"{dname} {cell_exec} fused {name}: a replay called a wrapper")
        latency[name] = {
            mode: {"p50_ms": statistics.median(v), "block_p50_ms": blocks[mode], "mean_ms": statistics.fmean(v),
                   "min_ms": min(v), "max_ms": max(v), "n": len(v), **windows[(mode, thr)]}
            for mode, v in lat.items()
        }
        for v in latency[name].values():
            v["device_busy_share_at_p50"] = v["device_ms_per_image"] / v["p50_ms"]
        latency[name]["segment_loop"]["cell_launches_per_image"] = per_image
    emit({"phase": "engine_modes", "dtype": dname, "cell_exec": cell_exec, "hw": list(FULL_HW),
          "batch": 1, "confidence": "entropy", "checks": checks, "captures": engine.captures,
          "warmup_capture_two_replays_kernels": graph_kernels,
          "latency": latency, "order": "segment_loop, fused, fused, segment_loop",
          "nvidia_smi": ctx["smi"]})


def phase_trained(ctx):
    from auto_dynamic_deeplab_torch.bridge import load_jax_variables
    from auto_dynamic_deeplab_torch.data import DataLoader
    from auto_dynamic_deeplab_torch.data.beacon import BeaconSegmentation, gen_item
    from auto_dynamic_deeplab_torch.models import ADD, EDM
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.train.evaluator import Evaluation
    from auto_dynamic_deeplab_torch.utils.restore import load_product_proof

    root = Path(__file__).resolve().parent
    backbone, edm_vars, meta = load_product_proof(root / "artifacts" / "product_proof")
    ref = json.loads((root / "tests" / "torch_product_proof_ref.json").read_text())
    m, hw, thr = meta["model"], tuple(meta["hw"]), meta["threshold_median"]
    cfg = NETWORK_ARCH[m["network_arch"]]
    ncls, seeds = m["num_classes"], meta["val_seeds"]
    if not (ref["val_seeds"] == seeds and ref["threshold"] == thr and tuple(ref["hw"]) == hw):
        raise AssertionError("the recorded oracle is not of meta.json's images and threshold")
    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    items = [gen_item(s, hw) for s in seeds]
    far = [abs(c - thr) > 1e-3 for c in ref["exit0_edm_confidence"]]
    exits_ref = [0 if c <= thr else 1 for c in ref["exit0_edm_confidence"]]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, ncls, F=m["F"], B=m["B"],
                    low_level_layer=cfg["low_level_layer"], dtype=dtype)
        load_jax_variables(model, backbone)  # raises on a missing or unused key
        edm = load_jax_variables(EDM(model.feature_channels(model.exit_layers[0]), dtype=dtype), edm_vars)
        evaluation = Evaluation(model, ncls, edm=edm)

        def loader():
            return DataLoader(BeaconSegmentation(seeds, hw), 1, shuffle=False, drop_last=False, num_workers=4)

        static = evaluation.validate(loader())
        gated = evaluation.dynamic_inference(loader(), threshold=thr, confidence="edm")
        engine = evaluation.engine
        per_image = [engine.infer_fused(it["image"][None], thr, "edm") for it in items]
        confs = [r[3] for r in per_image]
        exits = [r[1] for r in per_image]
        row = {
            "phase": "trained_weights", "dtype": dname, "hw": list(hw), "threshold": thr,
            "static_miou_per_exit": static["miou"], "ref_static_miou_per_exit": ref["static_miou_per_exit"],
            "gated_miou": gated["miou"], "ref_gated_miou": ref["gated_miou"],
            "exit_histogram": gated["exit_histogram"], "ref_exit_histogram": ref["exit_histogram"],
            "max_abs_conf_err": max(abs(a - b) for a, b in zip(confs, ref["exit0_edm_confidence"])),
            "exits_differ_far_from_threshold": [s for s, e, r, f in zip(seeds, exits, exits_ref, far)
                                                if f and e != r],
            "exits_differ_near_threshold": [s for s, e, r, f in zip(seeds, exits, exits_ref, far)
                                            if not f and e != r],
            "mean_latency_ms": gated["mean_latency_s"] * 1e3,
            "tpu_meta_for_information": {"static_miou_per_exit": meta["static_miou_per_exit"],
                                         "gated_miou": meta["gated_miou"]},
            "oracle": f"JAX {ref['jax_version']} on {ref['jax_backend']}, fp32", "nvidia_smi": ctx["smi"],
        }
        if gated["exit_histogram"] != [exits.count(0), exits.count(1)]:
            raise AssertionError(f"trained {dname}: the evaluator's histogram {gated['exit_histogram']} is not "
                                 f"the per-image exits' {exits}")
        if dtype == torch.float32:
            # a confidence within the tolerance puts every image farther than
            # it from the threshold on the oracle's side
            tol = TRAINED_FP32_CONF_TOL
            row["conf_tol"] = tol
            row["exits_differ_beyond_conf_tol"] = [s for s, e, r, c in zip(seeds, exits, exits_ref,
                                                                            ref["exit0_edm_confidence"])
                                                   if abs(c - thr) > tol and e != r]
            bad = [abs(a - b) > 2e-3 for a, b in zip(static["miou"], ref["static_miou_per_exit"])]
            if (any(bad) or abs(gated["miou"] - ref["gated_miou"]) > 2e-3 or row["max_abs_conf_err"] > tol
                    or row["exits_differ_beyond_conf_tol"]):
                raise AssertionError(f"trained fp32 against the JAX-CPU oracle: {row}")
        elif not all(0.0 <= v <= 1.0 for v in [*static["miou"], gated["miou"]]):
            raise AssertionError(f"trained {dname}: mIoU out of range: {row}")
        # infer_batch on 8 images with both exits (4 and 4, each more than
        # 1e-3 from the threshold) against per-image infer_fused
        pick = ([i for i in range(len(seeds)) if far[i] and exits_ref[i] == 0][:4]
                + [i for i in range(len(seeds)) if far[i] and exits_ref[i] == 1][:4])
        batch = torch.from_numpy(np.stack([items[i]["image"] for i in pick]))
        logits, k = engine.infer_batch(batch, thr, "edm")
        tol = 1e-3 if dtype == torch.float32 else 5e-2
        errs = []
        for j, i in enumerate(pick):
            want, k_want = per_image[i][0], per_image[i][1]
            if int(k[j]) != k_want:
                raise AssertionError(f"trained {dname} infer_batch: image {seeds[i]} exits at {int(k[j])}, "
                                     f"per image at {k_want}")
            ref_max = want.float().abs().max().item()
            errs.append((logits[j].float() - want[0].float()).abs().max().item() / ref_max)
        if not (max(errs) <= tol and torch.isfinite(logits).all()):
            raise AssertionError(f"trained {dname} infer_batch: relative logits error {max(errs)} > {tol}")
        row["infer_batch"] = {"n": len(pick), "exits": k.tolist(), "max_rel_err": max(errs), "tol_rel": tol}
        emit(row)
        del evaluation, engine, model


TRAIN_HW = (769, 769)  # the reference's Cityscapes train crop, cli.train's --crop-size
TRAIN_BATCH = 4       # cli.train's --batch-size
TRAIN_IMAGES = 40     # 10 steps an epoch
TRAIN_VAL = max(8, TRAIN_IMAGES // 4)  # the synthetic validation set's images


def _tiny_train_models():
    """A small ADD (path [1,2,2,2,3,2], F=4, 7 classes) with seeded weights
    and BN statistics, one on the CPU and one on the card."""
    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    out = []
    for device in ("cpu", "cuda"):
        model = ADD([1, 2, 2, 2, 3, 2], [1], AUTODEEPLAB_GENOTYPE, 7, F=4, B=5)
        g = torch.Generator().manual_seed(3)
        out.append(randomize_bn(init_params(model, g), g).to(device))
    return out


def _state_err(model, ref) -> float:
    """max over tensors of |Δ| / max(1, max|ref|)."""
    want = ref.state_dict()
    return max((t.detach().cpu().double() - want[k].double()).abs().max().item()
               / max(1.0, want[k].abs().max().item()) for k, t in model.state_dict().items())


def _train_parity():
    """Three fp32 steps (TF32 off) of the tiny ADD on the card against the
    same steps on the CPU. The first step's loss |Δ| ≤ 1e-5 relative and
    the parameters and BN statistics after it ≤ 1e-3·max(1, max|ref|); the
    later losses ≤ 5e-2 relative: at batch 2 the ASPP image-pool BN
    normalizes over two values and makes the step's gradient
    ill-conditioned in fp32 (tests/test_torch_train.py)."""
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer

    g = torch.Generator().manual_seed(4)
    image = torch.randn(2, 33, 65, 3, generator=g)
    label = torch.randint(0, 7, (2, 33, 65), generator=g)
    label[:, :2] = 255
    models = _tiny_train_models()
    steps = [TrainStep(m, make_optimizer(m.parameters()), lr_schedule("poly", 0.02, 1, 4)) for m in models]
    losses = [[], []]
    for k in range(3):
        for i, (m, step) in enumerate(zip(models, steps)):
            losses[i].append(step(image.to(next(m.parameters()).device), label.to(next(m.parameters()).device)).item())
        if k == 0:
            first_err = _state_err(models[1], models[0])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0])]
    row = {"losses_cpu": losses[0], "losses_card": losses[1], "loss_rel_err": rel,
           "state_err_step1": first_err, "state_err_step3": _state_err(models[1], models[0]),
           "tol": {"loss_step1": 1e-5, "state_step1": 1e-3, "loss_later": 5e-2}}
    if not (rel[0] <= 1e-5 and first_err <= 1e-3 and max(rel[1:]) <= 5e-2):
        raise AssertionError(f"train steps on the card and on the CPU disagree: {row}")
    return row


def _counts(kernels):
    return {name: f.launches for name, f in kernels.items()}


def phase_train(ctx):
    """Stage 2 and 3 through their entry points on the card: cli.train at
    full width, cli.train_edm, cli.evaluate --resume / --edm-resume."""
    from auto_dynamic_deeplab_torch.cli import evaluate, train, train_edm
    from auto_dynamic_deeplab_torch.data import make_data_loader
    from auto_dynamic_deeplab_torch.kernels.confidence import entropy_argmax_reference
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer
    from auto_dynamic_deeplab_torch.utils.saver import restore_checkpoint

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    kernels = _all_kernels()
    total = Counter()
    emit({"phase": "train", "check": "card_vs_cpu_steps", **_train_parity()})

    crop = [str(v) for v in TRAIN_HW]
    with tempfile.TemporaryDirectory() as tmp:
        # validation at batch 1; fp32 trains 2 epochs of 10 steps and
        # validates after each (the second validation must see the weights
        # the first packed for K1 changed), bf16 1 epoch
        base = ["--synthetic-crop", *crop, "--synthetic-length", str(TRAIN_IMAGES), "--batch-size", str(TRAIN_BATCH),
                "--test-batch-size", "1", "--eval-interval", "1", "--workers", "8", "--run-dir", tmp]
        runs = {}
        for name, extra in (("fp32", ["--epochs", "2"]), ("bf16", ["--epochs", "1", "--bf16"])):
            for f in kernels.values():
                f.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = train.main(base + extra + ["--checkname", f"ADD_{name}"])
            wall = time.perf_counter() - t0
            counts = _counts(kernels)
            step_ms = statistics.median(result["step_ms"][1:])
            ctx[f"train_{name}_step_ms"] = step_ms
            epochs = int(extra[1])
            row = {
                "run": f"cli.train {name}", "hw": list(TRAIN_HW), "batch": TRAIN_BATCH, "epochs": epochs,
                "steps_per_epoch": len(result["step_ms"]), "step_ms_all": result["step_ms"],
                "step_ms_median_after_first": step_ms, "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
                "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "train_loss": result["train_loss"],
                "val_miou": result["miou"], "wall_s": wall, "launches": counts, "nvidia_smi": ctx["smi"],
            }
            # one K1 an image and one K2 an exit in each validation; none in training
            want = {"fused_stems": TRAIN_VAL * epochs, "entropy_argmax_triton": 2 * TRAIN_VAL * epochs}
            if any(counts[k] != v for k, v in want.items()) or not np.isfinite(result["train_loss"]):
                raise AssertionError(f"cli.train {name}: {row}, want launches {want}")
            emit({"phase": "train", **row})
            total.update(counts)
            runs[name] = result

        # bf16, 20 steps on one fixed full-width batch: the loss falls
        model = _flagship(torch.bfloat16, seed=5).cuda()
        step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule("poly", 0.05, 1, 20))
        loader, _, _ = make_data_loader("synthetic", TRAIN_BATCH, synthetic_length=TRAIN_BATCH,
                                        synthetic_crop=TRAIN_HW, num_workers=4)
        batch = next(iter(loader))
        image, label = (torch.as_tensor(batch[k]).cuda() for k in ("image", "label"))
        losses = [step(image, label) for _ in range(20)]
        losses = torch.stack(losses).tolist()
        emit({"phase": "train", "run": "bf16 one batch, 20 steps", "losses": losses})
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"bf16 20 steps on one batch: the loss did not fall: {losses}")
        del model, step

        # stage 3 on the fp32 checkpoint, 8 synthetic images at 1025x2049
        exp = runs["fp32"]["experiment_dir"]
        edm_argv = ["--synthetic-crop", str(FULL_HW[0]), str(FULL_HW[1]), "--synthetic-length", "8",
                    "--workers", "8", "--run-dir", tmp, "--resume", exp]
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        l1 = train_edm.main(edm_argv)
        counts = _counts(kernels)
        edm_exp = str(Path(tmp) / "synthetic" / "edm_C2" / "experiment_0")
        ent = np.load(next(Path(edm_exp).glob("entropy_*.npy")))
        # K2's entropies against its plain version on the same logits
        model = _flagship()
        model.load_state_dict(restore_checkpoint(str(Path(exp) / "checkpoint"))[0]["model"])
        model = model.cuda().eval()
        loader, _, _ = make_data_loader("synthetic", 1, synthetic_length=8, synthetic_crop=FULL_HW, num_workers=4)
        plain = []
        with torch.inference_mode():
            for b in loader:
                logits, _ = model.get_feature(torch.as_tensor(b["image"]).cuda(), class_leading=True)
                plain.append(entropy_argmax_reference(logits, 19, class_axis=1)[0].item())
        err = float(np.abs(np.sort(ent) - np.sort(plain)).max())
        row = {"run": "cli.train_edm --resume", "hw": list(FULL_HW), "n_images": 8, "edm_l1": l1,
               "wall_s": time.perf_counter() - t0, "launches": counts, "k2_entropy_max_abs_err": err}
        if counts["entropy_argmax_triton"] != 8 or counts["fused_stems"] != 8 or not (err <= 1e-5 and np.isfinite(l1)):
            raise AssertionError(f"cli.train_edm: {row}")
        emit({"phase": "train", **row})
        total.update(counts)
        del model

        # the checkpoint round trip: cli.evaluate --resume gives the trainer's last validation
        ev = ["--synthetic-crop", *crop, "--synthetic-length", str(TRAIN_IMAGES), "--workers", "8", "--resume", exp]
        for f in kernels.values():
            f.launches = 0
        stats = evaluate.main(ev)
        counts = _counts(kernels)
        want = runs["fp32"]["miou"]
        diff = max(abs(a - b) for a, b in zip(stats["miou"], want))
        row = {"run": "cli.evaluate --resume", "miou": stats["miou"], "trainer_miou": want,
               "max_abs_diff": diff, "launches": counts}
        if diff > 1e-9 or counts["fused_stems"] != TRAIN_VAL or counts["entropy_argmax_triton"] != 2 * TRAIN_VAL:
            raise AssertionError(f"cli.evaluate --resume: {row}")
        emit({"phase": "train", **row})
        total.update(counts)

        for f in kernels.values():
            f.launches = 0
        stats = evaluate.main(ev + ["--dynamic", "--confidence", "edm", "--edm-resume", edm_exp])
        _check_dynamic_stats("dynamic_edm_trained", "xla", stats, TRAIN_VAL)
        emit({"phase": "train", "run": "cli.evaluate --dynamic --confidence edm --resume --edm-resume",
              "stats": stats, "wrapper_calls": _counts(kernels)})
    launches = ctx.setdefault("launches", {})
    for name, n in total.items():
        launches[name] = launches.get(name, 0) + n
    ctx["train_launches"] = dict(total)


SEARCH_HW = (321, 321)  # the reference's search crop (scripts/search_cityscapes.sh)
SEARCH_BATCH = 16       # the published recipe's batch
# the published recipe (scripts/search_cityscapes.sh: net_supernet, F=20, B=5,
# C=2, cos lr 0.05 → 0.003, weight decay 8e-4, arch lr 1e-3) on 32 synthetic
# images: 2 weight steps, 2 arch steps on the seed-2 half (16 images, one
# batch, cycled), validation of 8 images at batch 1 (48 images, 3 + 3 steps,
# until the script passed 900 s)
SEARCH_RECIPE = ["--network", "net_supernet", "--F", "20", "--B", "5", "--C", "2", "--batch-size", "16",
                 "--synthetic-crop", "321", "321", "--synthetic-length", "32", "--epochs", "1",
                 "--alpha-epoch", "0", "--lr", "0.05", "--min-lr", "0.003", "--arch-lr", "1e-3",
                 "--weight-decay", "8e-4", "--arch-weight-decay", "1e-3", "--seed", "2", "--workers", "8"]
# the tolerances of tests/test_torch_search.py: losses relative, arch
# gradients L2 relative, the updated arch |Δ| on the components whose
# decayed gradient is above SEARCH_GRAD_FLOOR of its largest (Adam's first
# step is about -lr·sign(g): below that a component may flip its sign);
# the weight gradients L2 relative 5e-4: cuDNN's fp32 algorithms sum in
# another order than the CPU's (4.6e-5 and 9.6e-5 on the H100, where the
# CPU and JAX agree within 1.0e-5)
SEARCH_TOL = {"loss": 1e-5, "grad": 1e-4, "weight_grad": 5e-4, "arch": 1e-6}
SEARCH_GRAD_FLOOR = 1e-2


def _tiny_supernets(kind):
    """A tiny supernet (4 layers, F=2, B=2, 5 classes) with seeded weights,
    BN statistics and arch, one on the CPU and one on the card."""
    from auto_dynamic_deeplab_torch.models import ModelNetSearch, ModelSearch
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    out = []
    for device in ("cpu", "cuda"):
        kw = dict(num_layers=4, F=2, B=2, remat=False)
        model = (ModelSearch(5, exit_layer=2, **kw) if kind == "mixed"
                 else ModelNetSearch(5, [[1, 6], [0, 3], [4, 5], [2, 1]], C_index=(2,), **kw))
        g = torch.Generator().manual_seed(7)
        randomize_bn(init_params(model, g), g)
        with torch.no_grad():
            for p in model.arch_parameters():
                p.normal_(0.0, 1.0, generator=g)
        out.append(model.to(device))
    return out


def _rel_l2(a, ref) -> float:
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _search_parity(kind):
    """fp32 (TF32 off): one weight step and one arch step of a tiny
    supernet on the card against the same steps on the CPU."""
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import SearchSteps, make_arch_optimizer, make_optimizer

    g = torch.Generator().manual_seed(8)
    image = torch.randn(4, 65, 65, 3, generator=g)
    label = torch.randint(0, 5, (4, 65, 65), generator=g)
    label[:, :2] = 255
    models = _tiny_supernets(kind)
    runs = []
    for m in models:
        dev = next(m.parameters()).device
        steps = SearchSteps(m, make_optimizer(m.weight_parameters(), nesterov=False, weight_decay=8e-4),
                            make_arch_optimizer(m.arch_parameters(), 1e-3), lr_schedule("cos", 0.05, 1, 2, min_lr=0.003))
        w_loss = steps.weight_step(image.to(dev), label.to(dev)).item()
        w_grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
        arch0 = {n: p.detach().clone() for n, p in m.named_parameters() if n in ("alphas", "betas")}
        a_loss = steps.arch_step(image.to(dev), label.to(dev)).item()
        a_grads = {n: p.grad.clone() for n, p in m.named_parameters() if n in arch0}
        arch1 = {n: p.detach().clone() for n, p in m.named_parameters() if n in arch0}
        runs.append((w_loss, a_loss, w_grads, a_grads, arch0, arch1))
    cpu, card = runs
    row = {"kind": kind, "losses_cpu": cpu[:2], "losses_card": card[:2],
           "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(card[:2], cpu[:2])],
           "weight_grad_rel_l2": max(_rel_l2(card[2][n], g) for n, g in cpu[2].items()),
           "arch_grad_rel_l2": {n: _rel_l2(card[3][n], g) for n, g in cpu[3].items()}}
    arch_err = {}
    for n, g in cpu[3].items():
        decayed = g + 1e-3 * cpu[4][n]  # Adam's input: the gradient with the L2 term
        big = decayed.abs() > SEARCH_GRAD_FLOOR * decayed.abs().max()
        arch_err[n] = (card[5][n].cpu() - cpu[5][n])[big].abs().max().item()
    row["arch_update_max_abs_err"] = arch_err
    row["tol"] = SEARCH_TOL
    ok = (max(row["loss_rel_err"]) <= SEARCH_TOL["loss"] and row["weight_grad_rel_l2"] <= SEARCH_TOL["weight_grad"]
          and max(row["arch_grad_rel_l2"].values()) <= SEARCH_TOL["grad"]
          and max(arch_err.values()) <= SEARCH_TOL["arch"])
    if not ok:
        raise AssertionError(f"search steps on the card and on the CPU disagree: {row}")
    return row


def _search_row(name, argv, result, wall, batch, counts):
    """The run's step times (the median after the first step), images/s,
    peak memory and launches; raises on a non-finite loss."""
    w, a = result["step_ms"]["weight"], result["step_ms"]["arch"]
    w_ms, a_ms = statistics.median(w[1:]), statistics.median(a[1:])
    row = {"run": name, "argv": argv, "weight_step_ms_all": w, "arch_step_ms_all": a,
           "weight_step_ms": w_ms, "arch_step_ms": a_ms,
           # loader-A images searched a second: a bilevel iteration takes one
           # weight step and one arch step of ``batch`` images each
           "images_per_s": batch * 1e3 / (w_ms + a_ms),
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "train_loss": result["train_loss"],
           "val_miou": result["miou"], "decoded_path": result["decoded"]["path"].tolist(), "wall_s": wall,
           "launches": counts}
    if not np.isfinite(result["train_loss"]):
        raise AssertionError(f"{name}: non-finite loss: {row}")
    return row


def _check_path(path, layers):
    """A Viterbi path: starts at level 0 or 1, moves one level at most a
    layer, never deeper than the layer allows."""
    path = [int(v) for v in path]
    ok = (len(path) == layers and path[0] in (0, 1) and all(0 <= v <= min(3, i + 1) for i, v in enumerate(path))
          and all(abs(b - a) <= 1 for a, b in zip(path, path[1:])))
    if not ok:
        raise AssertionError(f"not a {layers}-layer trellis path: {path}")


def phase_search(ctx):
    """Stage 1 on the card: the tiny supernets' steps against the CPU, then
    cli.search at the published net_supernet recipe (and its resume), the
    mixed supernet through cli.search, the baseline through
    cli.search_layer."""
    from auto_dynamic_deeplab_torch.cli import search, search_layer
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.utils.initialize import init_params
    from auto_dynamic_deeplab_torch.utils.saver import restore_checkpoint

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    resolve_device("cuda")  # TF32 off
    for kind in ("mixed", "fixed"):
        emit({"phase": "search", "check": "card_vs_cpu_steps", **_search_parity(kind)})

    kernels = _all_kernels()
    total = Counter()

    def drive(name, main, argv, batch):
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = main(argv)
        wall = time.perf_counter() - t0
        counts = _counts(kernels)
        total.update(counts)
        row = _search_row(name, argv, result, wall, batch, counts)
        row["nvidia_smi"] = ctx["smi"]
        return result, row

    with tempfile.TemporaryDirectory() as tmp:
        argv = SEARCH_RECIPE + ["--run-dir", tmp, "--device", "cuda"]
        result, row = drive("cli.search net_supernet (published recipe)", search.main, argv, SEARCH_BATCH)
        exp = Path(result["experiment_dir"])
        arch = exp / "arch_epoch_0"
        path = np.load(arch / "network_path.npy")
        _check_path(path, 12)
        # the CLI's seeded initial betas, rebuilt on the CPU
        args = search.build_parser().parse_args(argv)
        init = init_params(search.build_model(args, 19, "net_supernet", (5,)), torch.Generator().manual_seed(2))
        moved = float(np.abs(np.load(arch / "betas.npy") - init.betas.detach().numpy()).max())
        row.update(arch_epoch_0_path=path.tolist(), betas_max_abs_move=moved)
        del init
        if not moved > 1e-4:
            raise AssertionError(f"the betas did not move: {row}")
        emit({"phase": "search", **row})

        result, row = drive("cli.search net_supernet --resume auto --epochs 2", search.main,
                            argv + ["--resume", "auto", "--epochs", "2"], SEARCH_BATCH)
        state, meta = restore_checkpoint(str(Path(result["experiment_dir"]) / "checkpoint"))
        a_steps = sorted({int(s["step"]) for s in state["a_opt"]["state"].values()})
        row.update(start_epoch=result["start_epoch"], checkpoint_epoch=meta["epoch"], weight_updates=state["step"],
                   arch_adam_steps=a_steps, momentum_buffers=len(state["w_opt"]["state"]))
        _check_path(np.load(Path(result["experiment_dir"]) / "arch_epoch_1" / "network_path.npy"), 12)
        if not (result["start_epoch"] == 1 and meta["epoch"] == 1 and state["step"] == 4 and a_steps == [4]):
            raise AssertionError(f"resume: {row}")
        emit({"phase": "search", **row})

        # the mixed supernet at 12 layers, F=8, B=5, batch 2: 4 images give
        # two bilevel iterations (loader B, the seed-2 half, needs 2); it
        # runs without remat (the path the recipe's run does not take),
        # which also takes a quarter off its host-bound steps
        mixed = ["--network", "supernet", "--F", "8", "--B", "5", "--batch-size", "2", "--synthetic-crop", "321", "321",
                 "--synthetic-length", "4", "--epochs", "1", "--alpha-epoch", "0", "--lr", "0.05", "--min-lr",
                 "0.003", "--arch-lr", "1e-3", "--weight-decay", "8e-4", "--seed", "2", "--workers", "8",
                 "--no-remat", "--run-dir", tmp, "--device", "cuda"]
        result, row = drive("cli.search supernet (mixed cells, F=8, --no-remat)", search.main, mixed, 2)
        genotype = np.load(Path(result["experiment_dir"]) / "arch_epoch_0" / "genotype.npy")
        row["genotype"] = genotype.tolist()
        _check_path(result["decoded"]["path"], 12)
        if genotype.shape != (10, 2) or not ((genotype[:, 1] >= 0) & (genotype[:, 1] < 8)).all():
            raise AssertionError(f"genotype: {row}")
        emit({"phase": "search", **row})

        layer = ["--network", "baseline_path", "--F", "20", "--B", "5", "--batch-size", "16", "--synthetic-crop",
                 "321", "321", "--synthetic-length", "32", "--epochs", "1", "--alpha-epoch", "0", "--lr", "0.05",
                 "--min-lr", "0.003", "--arch-lr", "1e-3", "--weight-decay", "8e-4", "--seed", "2",
                 "--workers", "8", "--run-dir", tmp, "--device", "cuda"]
        result, row = drive("cli.search_layer baseline_path", search_layer.main, layer, SEARCH_BATCH)
        _check_path(result["decoded"]["path"], 12)
        emit({"phase": "search", **row})
    ctx["search_launches"] = dict(total)
    if any(total.values()):
        raise AssertionError(f"a kernel ran on the search path, which has none: {dict(total)}")


CITY_HW = (1024, 2048)  # a Cityscapes frame
CITY_TRAIN = 16         # train frames over two cities: 4 steps of batch 4, two search halves of 8
CITY_VAL = 2            # val frames, validated at 1025x2049
CITY_SCALES = (0.5, 1.0, 1.7, 2.0)
# the flagship at its published train crop and batch, 2 epochs of 4 steps,
# validation at 1025x2049 after the last epoch (one K1 an image, one K2 an exit)
CITY_TRAIN_ARGV = ["--dataset", "cityscapes", "--crop-size", "769", "769", "--batch-size", "4", "--epochs", "2",
                   "--eval-interval", "2", "--test-batch-size", "1", "--workers", "4"]


def _city_frame(rng, hw=CITY_HW):
    """A seeded frame: a smooth uint8 image with noise, and raw label ids
    (VALID_CLASSES by the same field, 3% void ids)."""
    from auto_dynamic_deeplab_torch.data.cityscapes import VALID_CLASSES

    h, w = hw
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None]
    field = sum(np.sin(fy * yy * 6.28 + fx * xx * 6.28 + ph) for fy, fx, ph in rng.uniform(0.5, 6.0, (3, 3)))
    colour = rng.uniform(20, 60, 3).astype(np.float32)
    image = 128 + field[..., None] * colour + rng.randint(-8, 9, (h, w, 3)).astype(np.float32)
    classes = ((field - field.min()) / (np.ptp(field) + 1e-6) * (len(VALID_CLASSES) - 1e-3)).astype(np.int64)
    raw = np.asarray(VALID_CLASSES, np.uint8)[classes]
    void = rng.rand(h, w) < 0.03
    raw[void] = rng.choice([0, 1, 4, 6], size=int(void.sum()))
    return np.clip(image, 0, 255).astype(np.uint8), raw


def _city_frames():
    rng = np.random.RandomState(12)
    return [("train", f"city{k % 2}", k // 2, *_city_frame(rng)) for k in range(CITY_TRAIN)] + \
        [("val", "city2", k, *_city_frame(rng)) for k in range(CITY_VAL)]


def _write_city_tree(root: Path, frames):
    """The Cityscapes layout: leftImg8bit/<split>/<city>/*_leftImg8bit.png
    and gtFine/<split>/<city>/*_gtFine_labelIds.png."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def write(frame):
        split, city, k, image, raw = frame
        name = f"{city}_{k:06d}_000019"
        for kind, suffix, a in (("leftImg8bit", "leftImg8bit", image), ("gtFine", "gtFine_labelIds", raw)):
            d = root / kind / split / city
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(a).save(d / f"{name}_{suffix}.png")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, frames))


def _augment_inputs(rng):
    """Batch 4 at 769x769 from 1024x2048: scales CITY_SCALES, flips off/on."""
    frames = [_city_frame(rng) for _ in range(4)]
    from auto_dynamic_deeplab_torch.data.cityscapes import encode_segmap

    images = np.stack([f[0] for f in frames])
    masks = np.stack([encode_segmap(f[1]) for f in frames])
    scales = np.float32(CITY_SCALES)
    flips = np.array([False, True, False, True])
    offs = [[rng.randint(0, max(int(round(n * s)), c) - c + 1) for s in scales] for n, c in zip(CITY_HW, TRAIN_HW)]
    return images, masks, scales, flips, np.int32(offs[0]), np.int32(offs[1])


def _pipeline_parity():
    """The device augment on the card against the CPU; the eval preprocess
    on the card against the CPU; the native engine against numpy and PIL
    at scale 1."""
    from auto_dynamic_deeplab_torch.data import native
    from auto_dynamic_deeplab_torch.data import transforms as T
    from auto_dynamic_deeplab_torch.data.device_transforms import make_eval_preprocess, make_train_augment

    rng = np.random.RandomState(13)
    args = _augment_inputs(rng)
    card = make_train_augment(CITY_HW, TRAIN_HW, device="cuda")(*args)
    cpu = make_train_augment(CITY_HW, TRAIN_HW, device="cpu")(*args)
    img_err = (card[0].cpu() - cpu[0]).abs().max().item()
    img_tol = 1e-5 * max(1.0, cpu[0].abs().max().item())
    row = {"check": "device_augment_card_vs_cpu", "hw": list(CITY_HW), "crop": list(TRAIN_HW),
           "scales": list(CITY_SCALES), "flips": args[3].tolist(), "image_max_abs_err": img_err, "image_tol": img_tol,
           "labels_equal": bool(torch.equal(card[1].cpu(), cpu[1])),
           "eval_equal": all(torch.equal(a.cpu(), b) for a, b in zip(
               make_eval_preprocess(CITY_HW, FULL_HW, device="cuda")(args[0][:2], args[1][:2]),
               make_eval_preprocess(CITY_HW, FULL_HW, device="cpu")(args[0][:2], args[1][:2])))}
    # the native engine against numpy: labels equal, images within 1e-5
    # (the engine multiplies by 1/std where numpy divides)
    image, mask = args[0][0], args[1][0]
    nat = native.eval_full_native(image, mask, FULL_HW, T.CITYSCAPES_MEAN, T.CITYSCAPES_STD)
    ref = T.full_image_eval_preprocess(image, mask, FULL_HW)
    errs = {"eval": (float(np.abs(nat[0] - ref[0]).max()), bool(np.array_equal(nat[1], ref[1])))}
    from PIL import Image

    im, mk = Image.fromarray(image), Image.fromarray(mask)
    nat = T.train_preprocess_native(im, mk, TRAIN_HW, scale=1.0, rng=np.random.RandomState(3))
    ref = T.train_preprocess(im, mk, TRAIN_HW, scale=1.0, rng=np.random.RandomState(3))
    errs["train_scale1"] = (float(np.abs(nat[0] - ref[0]).max()), bool(np.array_equal(nat[1], ref[1])))
    row["native_vs_numpy"] = {k: {"image_max_abs_err": e, "labels_equal": eq} for k, (e, eq) in errs.items()}
    if not (img_err <= img_tol and row["labels_equal"] and row["eval_equal"]
            and all(e <= 1e-5 and eq for e, eq in errs.values())):
        raise AssertionError(f"input pipeline parity: {row}")
    return row


def _loader_rate(dataset, batch=4, workers=4):
    """One pass of the host loader over ``dataset``: images/s and ms a batch."""
    from auto_dynamic_deeplab_torch.data import DataLoader

    loader = DataLoader(dataset, batch, num_workers=workers)
    t0 = time.perf_counter()
    n = sum(len(b[next(iter(b))]) for b in loader)
    dt = time.perf_counter() - t0
    return {"images": n, "images_per_s": n / dt, "ms_per_batch": dt * 1e3 * batch / n}


def _device_augment_ms(runs=10):
    """CUDA-event ms a batch of 4 (1024x2048 uint8 → 769x769): the upload
    of the pixels and labels, and the augment on the card."""
    from auto_dynamic_deeplab_torch.data.device_transforms import make_train_augment

    args = _augment_inputs(np.random.RandomState(14))
    fn = make_train_augment(CITY_HW, TRAIN_HW, device="cuda")
    on_card = [torch.as_tensor(a).cuda() for a in args]
    upload = cuda_ms(lambda: (torch.as_tensor(args[0]).cuda(), torch.as_tensor(args[1]).cuda()), runs=runs)
    augment = cuda_ms(lambda: fn(*on_card), runs=runs)
    return {"batch": 4, "upload_ms": upload, "augment_ms": augment,
            "upload_bytes": int(args[0].nbytes + args[1].nbytes)}


def phase_input_pipeline(ctx):
    """The file datasets and the input pipeline at Cityscapes size (the
    tree written under a temporary directory): the installation, parity
    on the card, cli.train with and without --device-augment (fp32, bf16),
    the host loader alone, the device augment alone, cli.search on the
    search split, cli.train_edm and cli.evaluate --dynamic edm on it."""
    import importlib.util

    from auto_dynamic_deeplab_torch.cli import evaluate, search, train, train_edm
    from auto_dynamic_deeplab_torch.data import native

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    pil_version = None
    if importlib.util.find_spec("PIL") is not None:
        import PIL

        pil_version = PIL.__version__
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True).stdout.splitlines()[0]
    native.get_lib(strict=True)
    emit({"phase": "input_pipeline", "check": "installation", "pil": pil_version, "gxx": gxx,
          "native_library": str(native.library_path())})
    if pil_version is None:
        raise RuntimeError("Pillow is not installed: the file datasets decode their PNG frames with it")

    kernels = _all_kernels()
    total = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "cityscapes"
        t0 = time.perf_counter()
        _write_city_tree(root, _city_frames())
        emit({"phase": "input_pipeline", "check": "tree", "train": CITY_TRAIN, "val": CITY_VAL, "hw": list(CITY_HW),
              "written_s": time.perf_counter() - t0})
        t_tree = time.perf_counter()
        emit({"phase": "input_pipeline", **_pipeline_parity()})
        emit({"phase": "input_pipeline", "check": "device_augment_alone", **_device_augment_ms(),
              "nvidia_smi": ctx["smi"]})

        # the host loader alone over the train frames: the native engine, PIL, decode only
        from auto_dynamic_deeplab_torch.data import CityscapesSegmentation

        rates = {}
        for name, env, kw in (("native", "1", {}), ("pil", "0", {}), ("decode_only", "1", {"raw": True})):
            os.environ["ADD_TPU_NATIVE"] = env
            try:
                ds = CityscapesSegmentation(str(root), "train", crop_size=TRAIN_HW, **kw)
                rates[name] = _loader_rate(ds)
            finally:
                os.environ.pop("ADD_TPU_NATIVE")
        emit({"phase": "input_pipeline", "check": "host_loader_alone", "workers": 4, "batch": 4, **rates})

        def drive(name, main, argv):
            for f in kernels.values():
                f.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            result = main(argv)
            wall = time.perf_counter() - t
            counts = _counts(kernels)
            return result, {"run": name, "wall_s": wall, "launches": counts,
                            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}

        # each dtype's two routes in turns (host, device, device, host); a
        # route's step ms is the median of its two runs' last-epoch steps
        # after the first
        base = CITY_TRAIN_ARGV + ["--data-root", str(root), "--run-dir", tmp]
        steps = {}
        runs = {}
        for dname, extra in (("fp32", []), ("bf16", ["--bf16"])):
            for turn, route in enumerate(("host", "device", "device", "host")):
                key = f"{dname}_{route}"
                name = f"cli.train {dname} {route}"
                flag = ["--device-augment"] if route == "device" else []
                result, row = drive(name, train.main, base + extra + flag + ["--checkname", f"{key}_{turn}"])
                ms = result["step_ms"][1:]
                row.update(step_ms_last_epoch=result["step_ms"], step_ms_median_after_first=statistics.median(ms),
                           train_loss=result["train_loss"], val_miou=result["miou"], nvidia_smi=ctx["smi"])
                want = {"fused_stems": CITY_VAL, "entropy_argmax_triton": 2 * CITY_VAL}
                if any(row["launches"][k] != v for k, v in want.items()) or not np.isfinite(result["train_loss"]):
                    raise AssertionError(f"{name}: {row}, want launches {want}")
                emit({"phase": "input_pipeline", **row})
                total.update(row["launches"])
                steps.setdefault(key, []).extend(ms)
                runs.setdefault(key, result)
        step_ms = {k: statistics.median(v) for k, v in steps.items()}
        emit({"phase": "input_pipeline", "check": "step_ms_by_route", "step_ms": step_ms,
              "images_per_s": {k: 4e3 / v for k, v in step_ms.items()}, "steps": steps, "nvidia_smi": ctx["smi"]})

        # the search split at the net_supernet recipe, batch 4: the halves of
        # 8 frames give two weight and two arch steps
        argv = ["--dataset", "cityscapes", "--data-root", str(root), "--network", "net_supernet", "--F", "20",
                "--B", "5", "--C", "2", "--batch-size", "4", "--epochs", "1", "--alpha-epoch", "0", "--lr", "0.05",
                "--min-lr", "0.003", "--arch-lr", "1e-3", "--weight-decay", "8e-4", "--seed", "2", "--workers", "4",
                "--run-dir", tmp, "--device", "cuda"]
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        result = search.main(argv)
        row = _search_row("cli.search net_supernet on the Cityscapes split", argv, result,
                          time.perf_counter() - t, 4, _counts(kernels))
        _check_path(result["decoded"]["path"], 12)
        row["nvidia_smi"] = ctx["smi"]
        emit({"phase": "input_pipeline", **row})
        if any(row["launches"].values()):
            raise AssertionError(f"a kernel ran on the search path, which has none: {row['launches']}")

        # stage 3 on the full-size train frames, then the EDM-gated val frames
        exp = runs["fp32_host"]["experiment_dir"]
        result, row = drive("cli.train_edm cityscapes_edm --resume", train_edm.main,
                            ["--dataset", "cityscapes_edm", "--data-root", str(root), "--epochs", "1", "--workers", "4",
                             "--run-dir", tmp, "--resume", exp])
        row["edm_l1"] = result
        if row["launches"]["fused_stems"] != CITY_TRAIN or row["launches"]["entropy_argmax_triton"] != CITY_TRAIN \
                or not np.isfinite(result):
            raise AssertionError(f"cli.train_edm on the tree: {row}")
        emit({"phase": "input_pipeline", **row})
        total.update(row["launches"])
        edm_exp = str(Path(tmp) / "cityscapes_edm" / "edm_C2" / "experiment_0")
        stats, row = drive("cli.evaluate --dynamic --confidence edm", evaluate.main,
                           ["--dataset", "cityscapes", "--data-root", str(root), "--workers", "4", "--dynamic",
                            "--confidence", "edm", "--resume", exp, "--edm-resume", edm_exp])
        _check_dynamic_stats("dynamic_edm_cityscapes", "xla", stats, CITY_VAL)
        row["wrapper_calls"] = row.pop("launches")  # warm-up and capture; the replays call no wrapper
        emit({"phase": "input_pipeline", **row, "stats": stats})
        emit({"phase": "input_pipeline", "check": "seconds_after_tree", "seconds": time.perf_counter() - t_tree})
    launches = ctx.setdefault("launches", {})
    for name, n in total.items():
        launches[name] = launches.get(name, 0) + n
    ctx["data_launches"] = dict(total)


PARALLEL_TRAIN_IMAGES = 24  # cli.train --sync-bn: 1 epoch of 6 steps of batch 4
PARALLEL_SEARCH = ["--network", "net_supernet", "--F", "20", "--B", "5", "--C", "2", "--batch-size", "16",
                   "--synthetic-crop", "321", "321", "--synthetic-length", "32", "--epochs", "1",
                   "--alpha-epoch", "0", "--lr", "0.05", "--min-lr", "0.003", "--arch-lr", "1e-3",
                   "--weight-decay", "8e-4", "--arch-weight-decay", "1e-3", "--seed", "2", "--workers", "8",
                   "--device", "cuda"]
# world 1 against one device: the cross-replica BN takes JAX's one-pass
# variance max(E[x²] − E[x]², 0), cuDNN's training BN another; the first
# step's loss and the search's first weight-step loss |Δ| ≤ 1e-5
# relative, the state after one step ≤ 1e-3·max(1, max|ref|) per tensor
# (the tiny model's fp32 gradient is ill-conditioned: tests/test_torch_train.py)
PARALLEL_TOL = {"loss": 1e-5, "state": 1e-3}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _parallel_child():
    """Phase 13's process-group part, in a process of its own under a
    world-1 NCCL group (``parallel.distributed.initialize`` from the
    environment): one TrainStep with cross-replica BN against the
    single-device step, cli.train --sync-bn on the flagship, cli.search
    under the group and with --no-dp. Prints one JSON line per run."""
    import torch.distributed as dist

    from auto_dynamic_deeplab_torch.cli import search, train
    from auto_dynamic_deeplab_torch.ops.norm import set_bn_group
    from auto_dynamic_deeplab_torch.parallel import destroy, initialize, make_data_mesh
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer

    rank, world = initialize(device="cuda", timeout_s=300)
    resolve_device("cuda")  # TF32 off
    kernels = _all_kernels()
    try:
        if (rank, world, dist.get_backend()) != (0, 1, "nccl"):
            raise AssertionError(f"want a world-1 NCCL group, got rank {rank} of {world}, {dist.get_backend()}")
        # one fp32 step with the BNs over the group against the single-device step
        g = torch.Generator().manual_seed(4)
        image = torch.randn(2, 33, 65, 3, generator=g).cuda()
        label = torch.randint(0, 7, (2, 33, 65), generator=g).cuda()
        label[:, :2] = 255
        single, grouped = (m.cuda() for m in _tiny_train_models())
        grouped.load_state_dict(single.state_dict())
        mesh = make_data_mesh(2)
        set_bn_group(grouped, mesh.group)
        losses = [TrainStep(m, make_optimizer(m.parameters()), lr_schedule("poly", 0.02, 1, 4), mesh=ms)(image, label)
                  .item() for m, ms in ((single, None), (grouped, mesh))]
        row = {"check": "world1_nccl_train_step_vs_single_device", "losses": losses,
               "loss_rel_err": abs(losses[1] - losses[0]) / abs(losses[0]),
               "state_err": _state_err(grouped, single.cpu()), "tol": PARALLEL_TOL}
        print(json.dumps({"phase": "parallel", **row}), flush=True)
        if not (row["loss_rel_err"] <= PARALLEL_TOL["loss"] and row["state_err"] <= PARALLEL_TOL["state"]):
            raise AssertionError(f"world-1 NCCL step against the single-device step: {row}")
        del single, grouped

        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--sync-bn", "--synthetic-crop", *map(str, TRAIN_HW), "--synthetic-length",
                    str(PARALLEL_TRAIN_IMAGES), "--batch-size", str(TRAIN_BATCH), "--test-batch-size", "1",
                    "--epochs", "1", "--eval-interval", "1", "--workers", "8", "--run-dir", tmp]
            for f in kernels.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = train.main(argv)
            counts = _counts(kernels)
            n_val = max(8, PARALLEL_TRAIN_IMAGES // 4)  # the synthetic validation set
            row = {"run": "cli.train --sync-bn (world-1 NCCL)", "argv": argv, "step_ms_all": result["step_ms"],
                   "step_ms_median_after_first": statistics.median(result["step_ms"][1:]),
                   "train_loss": result["train_loss"], "val_miou": result["miou"], "n_val": n_val,
                   "peak_gb": torch.cuda.max_memory_allocated() / 2**30, "wall_s": time.perf_counter() - t0,
                   "launches": counts}
            print(json.dumps({"phase": "parallel", **row}), flush=True)
            want = {"fused_stems": n_val, "entropy_argmax_triton": 2 * n_val}
            if any(counts[k] != v for k, v in want.items()) or not np.isfinite(result["train_loss"]):
                raise AssertionError(f"cli.train --sync-bn: launches {counts}, want {want}; {row}")

            first = {}
            for name, extra in (("data-parallel (world-1 NCCL)", []), ("--no-dp", ["--no-dp"])):
                for f in kernels.values():
                    f.launches = 0
                t0 = time.perf_counter()
                result = search.main(PARALLEL_SEARCH + ["--run-dir", tmp, "--checkname", f"s{len(first)}"] + extra)
                counts = _counts(kernels)
                first[name] = result["step_losses"][0]
                row = _search_row(f"cli.search net_supernet {name}", PARALLEL_SEARCH + extra, result,
                                  time.perf_counter() - t0, 16, counts)
                row["step_losses"] = result["step_losses"]
                print(json.dumps({"phase": "parallel", **row}), flush=True)
                if any(counts.values()):
                    raise AssertionError(f"a kernel ran on the search path: {counts}")
            a, b = first.values()
            row = {"check": "search_first_weight_step_loss", "losses": first, "rel_err": abs(a - b) / abs(b),
                   "tol": PARALLEL_TOL["loss"]}
            print(json.dumps({"phase": "parallel", **row}), flush=True)
            if row["rel_err"] > PARALLEL_TOL["loss"]:
                raise AssertionError(f"the data-parallel search's first loss is not the single-device one: {row}")
    finally:
        destroy()


def _pipeline_runs(ctx, dtype, cell_exec, total):
    """The flagship pipelined over two stages on cuda:0 against the
    engine's segment loop, then its p50s."""
    from auto_dynamic_deeplab_torch.parallel import PipelinedDynamicInference
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    dev = resolve_device("cuda")
    dname = str(dtype).split(".")[-1]
    kernels = _all_kernels()
    model = _flagship(dtype, flat_eval=cell_exec == "flat").to(dev)
    engine = DynamicInferenceEngine(model, num_classes=19)
    shape = (1, *FULL_HW, 3)
    engine.warmup(shape, "entropy", 0.0)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, generator=g, device=dev)
    row = {"dtype": dname, "cell_exec": cell_exec, "hw": list(FULL_HW), "devices": ["cuda:0", "cuda:0"],
           "checks": [], "latency": {}, "nvidia_smi": ctx["smi"]}
    for name, thr, want_exit in (("early_exit", 1.01, 0), ("full_depth", 0.0, 1)):
        pipe = PipelinedDynamicInference(model, FULL_HW, ["cuda:0", "cuda:0"], "entropy", thr, num_classes=19)
        if [len(st["programs"]) for st in pipe.stages] != [1, 1]:
            raise AssertionError(f"two stages of one segment each, got {pipe.stages}")
        pipe.warmup()
        want, k_want, _, c_want = engine.infer(x, thr, "entropy")
        got, k_got, c_got = pipe.infer(x)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        row["checks"].append({"threshold": thr, "exit": k_got, "confidence": c_got, "bitwise_equal": equal})
        if not (k_got == k_want == want_exit and c_got == c_want and equal):
            raise AssertionError(f"pipeline {dname} {cell_exec} thr={thr}: exit {k_got} conf {c_got}, segment loop "
                                 f"exit {k_want} conf {c_want}, logits max |diff| "
                                 f"{(got.float() - want.float()).abs().max().item()}")
        for f in kernels.values():
            f.launches = 0
        times = []
        for i in range(3 + 20):
            xi = torch.randn(shape, generator=g, device=dev)
            pipe.synchronize()
            t0 = time.perf_counter()
            logits, k, _ = pipe.infer(xi)
            pipe.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if k != want_exit or not torch.isfinite(logits).all():
                raise AssertionError(f"pipeline {dname} {cell_exec} {name}: exit {k}")
        counts = _counts(kernels)
        want_counts = {n: 23 * v for n, v in _segments(dtype, cell_exec, 6 if want_exit == 0 else 12).items()}
        if counts != {n: want_counts.get(n, 0) for n in counts}:
            raise AssertionError(f"pipeline {dname} {cell_exec} {name}: launches {counts}, the routes predict "
                                 f"{want_counts}")
        total.update(counts)
        row["latency"][name] = {"p50_ms": statistics.median(times[3:]), "min_ms": min(times[3:]),
                                "max_ms": max(times[3:]), "n": 20, "launches_23_images": counts}
        del pipe
    emit({"phase": "parallel", "run": "PipelinedDynamicInference", **row})


def phase_parallel(ctx):
    """The parallel modes: the process-group part in a child process under
    a world-1 NCCL group, then the pipeline and the evaluator's refusal."""
    from auto_dynamic_deeplab_torch.data import make_data_loader
    from auto_dynamic_deeplab_torch.train.evaluator import Evaluation

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    total = Counter()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel-child"], env=env,
                          capture_output=True, text=True, timeout=900)
    rows = []
    for line in proc.stdout.splitlines():
        if line.startswith('{"phase": "parallel"'):
            rows.append(json.loads(line))
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the world-1 NCCL child failed ({proc.returncode}): {proc.stderr[-6000:]}")
    for row in rows:
        total.update(row.get("launches", {}))
        if row.get("run", "").startswith("cli.train"):
            emit({"phase": "parallel", "check": "sync_bn_train_step_vs_phase_10",
                  "world1_step_ms": row["step_ms_median_after_first"],
                  "single_device_step_ms": ctx.get("train_fp32_step_ms"), "nvidia_smi": ctx["smi"]})

    for dtype in (torch.float32, torch.bfloat16):
        for cell_exec in ("xla", "flat"):
            _pipeline_runs(ctx, dtype, cell_exec, total)

    # two pipeline stages on a one-card machine: the evaluator raises
    _, val, _ = make_data_loader("synthetic", 1, synthetic_length=8, synthetic_crop=(65, 65), num_workers=1)
    evaluation = Evaluation(_flagship(), 19)
    try:
        evaluation.dynamic_inference(val, confidence="entropy", pipeline_devices=torch.cuda.device_count() + 1)
    except RuntimeError as e:
        emit({"phase": "parallel", "check": "pipeline_devices_above_gpus_raises", "error": str(e)})
    else:
        raise AssertionError("dynamic_inference(pipeline_devices > GPUs) did not raise")
    ctx["parallel_launches"] = dict(total)


def _variant_engine_row(ctx, dtype, cell_exec):
    """Phase 14's engine numbers for one dtype and variant: the fused
    graphs against the segment loop on one image (same exit, bitwise
    logits), the segment loop's kernel launches per image against the
    routes, the fused p50 of 20 images after 3 early exit and full depth,
    and device ms, host launches and readbacks per image from a profiled
    window of 3 images."""
    from auto_dynamic_deeplab_torch.cli.evaluate import CELL_EXEC
    from auto_dynamic_deeplab_torch.runtime import resolve_device
    from auto_dynamic_deeplab_torch.train.dynamic import DynamicInferenceEngine

    dev = resolve_device("cuda")
    shape = (1, *FULL_HW, 3)
    dname = str(dtype).split(".")[-1]
    kernels = _all_kernels()
    engine = DynamicInferenceEngine(_flagship(dtype, **CELL_EXEC[cell_exec]).to(dev), num_classes=19)
    g = torch.Generator(device=dev).manual_seed(5)
    engine.warmup(shape, "entropy", 0.0)
    row = {"dtype": dname, "cell_exec": cell_exec, "launches_per_image": {}}
    launched = Counter()
    x = torch.randn(shape, generator=g, device=dev)
    for name, thr, want_exit in (("early_exit", 1.01, 0), ("full_depth", 0.0, 1)):
        for f in kernels.values():
            f.launches = 0
        want, k_want, _, c_want = engine.infer(x, thr, "entropy")
        counts = {n: f.launches for n, f in kernels.items()}
        got, k_got, _, c_got = engine.infer_fused(x, thr, "entropy")
        torch.cuda.synchronize()
        if not (k_got == k_want == want_exit and c_got == c_want and torch.equal(got, want)):
            raise AssertionError(f"{dname} {cell_exec} thr={thr}: fused exit {k_got} conf {c_got}, segment "
                                 f"loop exit {k_want} conf {c_want}, want exit {want_exit}")
        routes = _segments(dtype, cell_exec, 6 if want_exit == 0 else 12)
        if counts != {n: routes.get(n, 0) for n in kernels}:
            raise AssertionError(f"{dname} {cell_exec} {name}: launches {counts}, the routes predict {dict(routes)}")
        row["launches_per_image"][name] = counts
        launched.update(counts)
        times = []
        for _ in range(3 + 20):
            _, k, dt, _ = engine.infer_fused(torch.randn(shape, generator=g, device=dev), thr, "entropy")
            if k != want_exit:
                raise AssertionError(f"{dname} {cell_exec} fused {name}: exit {k}")
            times.append(dt * 1e3)
        xs = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
        row[name] = {"p50_ms": statistics.median(times[3:]), "min_ms": min(times[3:]), "max_ms": max(times[3:]),
                     "n": 20, **_window(engine, engine.infer_fused, xs, thr)}
        row[name]["device_busy_share_at_p50"] = row[name]["device_ms_per_image"] / row[name]["p50_ms"]
    row["captures"] = engine.captures
    emit({"phase": "variants", "engine": row, "hw": list(FULL_HW), "batch": 1, "confidence": "entropy",
          "nvidia_smi": ctx["smi"]})
    return launched


def phase_variants(ctx):
    """Phase 14: the other --cell-exec values on the card (see the module
    docstring)."""
    from auto_dynamic_deeplab_torch.cli import evaluate
    from auto_dynamic_deeplab_torch.utils import profiling
    from auto_dynamic_deeplab_torch.utils.flops import count_params

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    kernels = _all_kernels()
    genotype = _flagship_genotype()
    n_img = 8
    total = Counter()

    def drive(fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        return out, {name: f.launches for name, f in kernels.items()}

    with tempfile.TemporaryDirectory() as tmp:
        # seeded weights, BN statistics drifted off their initial values,
        # given to every run as the CLI's --resume checkpoint
        xla_model = _flagship()
        with torch.no_grad():
            # the seeded logits reach 1e4, where every image's exit-0 entropy
            # lies within 1e-4 of 0: scaled, the entropies spread and the
            # dynamic check below separates images
            xla_model.decoder.classifier.kernel.mul_(1e-3)
            xla_model.decoder.classifier.bias.mul_(1e-3)
        torch.save({"model": xla_model.state_dict()}, os.path.join(tmp, "checkpoint"))
        n_params = count_params(xla_model)
        base = ["--dataset", "synthetic", "--synthetic-crop", str(FULL_HW[0]), str(FULL_HW[1]),
                "--synthetic-length", str(n_img), "--workers", "4"]

        def build(cell_exec):
            args = evaluate.build_parser().parse_args(base + ["--resume", tmp, "--cell-exec", cell_exec])
            return evaluate.build(args)[0]

        # static logits and dynamic exits against xla on the same weights and images
        ref = build("xla")
        gen = torch.Generator(device="cuda").manual_seed(41)
        xs = [torch.randn((1, *FULL_HW, 3), generator=gen, device="cuda") for _ in range(n_img)]
        with torch.inference_mode():
            refs = [[o.float() for o in ref.model(x, class_leading=True)] for x in xs[:2]]
        confs = [ref.engine.infer_fused(x, 2.0, "entropy")[3] for x in xs]
        thr = float(np.median(confs))
        ref_exits = [ref.engine.infer_fused(x, thr, "entropy")[1] for x in xs]
        # utils/profiling: one forward's device time, and a trace
        with torch.inference_mode():
            forward_s = profiling.device_time(lambda: ref.model(xs[0]), iters=5, warmup=2)
            trace_dir = os.path.join(tmp, "trace")
            with profiling.trace(trace_dir):
                ref.model(xs[0])
        trace_bytes = os.path.getsize(os.path.join(trace_dir, profiling.TRACE_FILE))
        if not trace_bytes:
            raise AssertionError("profiling.trace wrote an empty trace")
        emit({"phase": "variants", "check": "profiling", "xla_forward_device_time_ms": forward_s * 1e3,
              "trace_bytes": trace_bytes})
        del ref
        gc.collect()
        for cell_exec in VARIANTS:
            ev = build(cell_exec)
            with torch.inference_mode():
                outs, counts = drive(lambda: [ev.model(x, class_leading=True) for x in xs[:2]])  # noqa: B023
            rows = []
            for o_img, r_img in zip(outs, refs):
                for o, r in zip(o_img, r_img):
                    err, tol = (o.float() - r).abs().max().item(), 1e-3 * r.abs().max().item()
                    if not (torch.isfinite(o).all() and err <= tol):
                        raise AssertionError(f"{cell_exec}: logits differ from xla's by {err} > {tol}")
                    rows.append({"max_abs_err": err, "tol": tol})
            total.update(counts)
            exits, vconfs = [], []
            for x in xs:
                _, k, _, c = ev.engine.infer_fused(x, thr, "entropy")
                exits.append(k)
                vconfs.append(c)
            far = [i for i, c in enumerate(confs) if abs(c - thr) > 1e-4]
            if len(far) < n_img // 2 or any(exits[i] != ref_exits[i] for i in far):
                raise AssertionError(f"{cell_exec} --dynamic: exits {exits}, xla's {ref_exits} (threshold {thr}, "
                                     f"{len(far)} images farther than 1e-4 from it)")
            emit({"phase": "variants", "cell_exec": cell_exec, "check": "against_xla", "exits_logits": rows,
                  "logit_launches": counts, "threshold": thr, "exits": exits, "xla_exits": ref_exits,
                  "max_conf_diff": max(abs(a - b) for a, b in zip(vconfs, confs)), "images_compared": len(far)})
            del ev
            gc.collect()
            # through the CLI: static with --flops, then --dynamic (the fused graphs)
            argv = base + ["--resume", tmp, "--cell-exec", cell_exec]
            stats, counts = drive(lambda: evaluate.main(argv + ["--flops"]))  # noqa: B023
            _check_run("static", cell_exec, stats, counts, n_img, genotype)
            if stats["complexity"]["params"] != n_params:
                raise AssertionError(f"{cell_exec} --flops: params {stats['complexity']['params']}, xla {n_params}")
            emit({"phase": "variants", "cell_exec": cell_exec, "run": "static", "stats": stats, "launches": counts})
            total.update(counts)
            dyn = argv + ["--dynamic", "--confidence", "entropy", "--threshold", "0"]
            _, ran = _fused_cli_run(kernels, "dynamic_entropy_thr0", cell_exec, lambda: evaluate.main(dyn),  # noqa: B023
                                    genotype, n_img, phase="variants")
            total.update(ran)
        geno = Path(tmp) / "mixed_genotype.npy"
        np.save(geno, np.array(MIXED_GENOTYPE, dtype=np.int64))
        stats, counts = drive(lambda: evaluate.main(base + ["--cell-exec", "flat-packed", "--genotype", str(geno)]))
    _check_run("static", "flat-packed", stats, counts, n_img, MIXED_GENOTYPE)
    for name in ("sep_fused", "dense_stage"):
        if counts[name] == 0:
            raise AssertionError(f"the mixed genotype under flat-packed launched no {name}: {counts}")
    emit({"phase": "variants", "cell_exec": "flat-packed", "run": "static_mixed_genotype", "stats": stats,
          "launches": counts})
    total.update(counts)
    for dtype in (torch.float32, torch.bfloat16):
        for cell_exec in VARIANTS:
            total.update(_variant_engine_row(ctx, dtype, cell_exec))
            gc.collect()  # the engine's graphs and their pool go with it
            torch.cuda.empty_cache()
    missing = [name for name in kernels if total[name] == 0]
    if missing:
        raise AssertionError(f"kernels of the variants' paths never launched: {missing} ({dict(total)})")
    ctx["variants_launches"] = dict(total)


SHARDED_IMAGES = 3    # timed forwards of each kind after one warm-up (5 until the script passed 900 s)
# the other cell executions under spatial sharding, (--cell-exec, dtype, mixed
# genotype), each SHARDED_RUN_IMAGES timed forwards after one warm-up:
# flat-packed with the mixed genotype runs K4 and K6, flat fp32 K3, K5 and K6
SHARDED_RUNS = (
    ("flat", torch.float32, False), ("flat", torch.bfloat16, False), ("flat-packed", torch.float32, True),
    ("packed", torch.float32, False), ("packed", torch.bfloat16, False),
    ("dense-sep", torch.float32, False), ("dense-sep", torch.bfloat16, False),
)
SHARDED_RUN_IMAGES = 2  # 3 until the script passed 900 s
SHARDED_TP_HW, SHARDED_TP_BATCH = (385, 385), 2  # the (1, 2) TP step's crop: every gather goes through the host
# spatial sharding against the unsharded forward on the card, |Δ| ≤ tol·max|ref|:
# fp32 sums a band's convs and resizes in another order; bf16 also rounds
# them at other points, a unit of bf16 (2^-8 relative) here and there
SHARDED_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the (1, 2) TP step against the single-device step: tests/test_tensor_parallel.py's
# criteria (a split re-associates fp32 sums and flips near-tie selections)
TP_TOL = {"loss": 2e-4, "frac_above_2e-3": 0.05, "max": 0.05, "bn_rtol": 1e-2, "bn_atol": 1e-4}


def _spatial_run(mesh, backend, dev, cell_exec, dtype, genotype, images):
    """One spatially sharded forward of the flagship at FULL_HW on this
    rank's band: its rows against the same execution's unsharded forward,
    one K1 launch, K3-K6 launches against the routes (every cell whose
    level holds rows on this rank), peak memory, bytes received, p50s.
    Returns the row."""
    import torch.distributed as dist

    from auto_dynamic_deeplab_torch.cli.evaluate import CELL_EXEC
    from auto_dynamic_deeplab_torch.kernels.stems import fused_stems
    from auto_dynamic_deeplab_torch.nas import NETWORK_ARCH
    from auto_dynamic_deeplab_torch.parallel import spatial_shard_forward

    world, dname = dist.get_world_size(), str(dtype).split(".")[-1]
    model = _flagship(dtype, genotype=genotype, **CELL_EXEC[cell_exec]).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1, *FULL_HW, 3, generator=g, device=dev)
    fwd = spatial_shard_forward(model, mesh)
    bands = fwd.bands(FULL_HW[0])
    lo, hi = bands.band(FULL_HW[0])
    fns = {"fused_stems": fused_stems, **_cell_fns()}
    fwd(x)  # warm-up: cuDNN's choices, the kernels' folded weights
    torch.cuda.synchronize()
    dist.barrier()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    outs = fwd(x)
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in fns.items()}
    peak_sharded = torch.cuda.max_memory_allocated(dev)
    exchanged = fwd.exchanged_bytes
    outs = [o.float().cpu() for o in outs]
    times = []
    for _ in range(images):
        dist.barrier()
        t0 = time.perf_counter()
        fwd(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        refs = [r.float().cpu() for r in model(x)]
        peak_plain = torch.cuda.max_memory_allocated(dev)
        plain_times = []
        dist.barrier()
        if dist.get_rank() == 0:  # alone on the card
            for _ in range(images):
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                plain_times.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
    errs = []
    for o, r in zip(outs, refs):
        want = r[:, lo:hi]
        if o.shape != want.shape or not torch.isfinite(o).all():
            raise AssertionError(f"spatial {cell_exec} {dname}: rows {tuple(o.shape)}, want {tuple(want.shape)}")
        errs.append({"max_abs_err": (o - want).abs().max().item(), "max_abs_ref": r.abs().max().item(),
                     "bitwise": torch.equal(o, want)})
    spans = {level: bands.band(h) for level, (_, h, _) in enumerate(CELL_SHAPES, start=1)}
    held = [i for i, level in enumerate(NETWORK_ARCH[2]["path"]) if spans[level][1] > spans[level][0]]
    want_cells = expected_cell_launches(genotype or _flagship_genotype(), dtype, held) \
        if CELL_EXEC[cell_exec].get("flat_eval") else Counter()
    row = {"run": f"spatial_shard_forward world {world} ({backend})", "backend": backend, "world": world,
           "rank": dist.get_rank(), "cell_exec": cell_exec, "genotype": "mixed" if genotype else "flagship",
           "dtype": dname, "hw": list(FULL_HW), "band": [lo, hi], "exits": errs,
           "tol_rel_to_max_ref": SHARDED_TOL[dname], "k1_launches": launches["fused_stems"],
           "cells_holding_rows": len(held), "cell_launches_want": {k: want_cells.get(k, 0) for k in CELL_KERNELS},
           "exchanged_bytes_per_image": exchanged, "peak_gb_sharded": peak_sharded / 2**30,
           "peak_gb_unsharded": peak_plain / 2**30, "p50_ms_sharded": statistics.median(times), "ms_sharded": times,
           "p50_ms_unsharded": statistics.median(plain_times) if plain_times else None, "launches": launches}
    print(json.dumps({"phase": "sharded", **row}), flush=True)
    bad = [e for e in errs if e["max_abs_err"] > SHARDED_TOL[dname] * e["max_abs_ref"]]
    if bad or launches["fused_stems"] != 1 or any(launches[k] != want_cells.get(k, 0) for k in CELL_KERNELS):
        raise AssertionError(f"spatial sharding {cell_exec} {dname} world {world}: {row}")
    del model, fwd, outs, refs
    torch.cuda.empty_cache()
    return row


def _sharded_spatial(mesh, backend, dev):
    """Spatial sharding of the flagship at FULL_HW: the default execution
    (xla) in fp32 and bf16 over SHARDED_IMAGES timed forwards, then each
    of SHARDED_RUNS over SHARDED_RUN_IMAGES. Returns the rows."""
    rows = [_spatial_run(mesh, backend, dev, "xla", dtype, None, SHARDED_IMAGES)
            for dtype in (torch.float32, torch.bfloat16)]
    for cell_exec, dtype, mixed in SHARDED_RUNS:
        rows.append(_spatial_run(mesh, backend, dev, cell_exec, dtype, MIXED_GENOTYPE if mixed else None,
                                 SHARDED_RUN_IMAGES))
    return rows


def _state_bytes(model, optimizer) -> int:
    t = list(model.parameters()) + list(model.buffers())
    t += [st["momentum_buffer"] for st in optimizer.state.values() if st.get("momentum_buffer") is not None]
    return sum(v.numel() * v.element_size() for v in t)


def _sharded_tp(n_data, n_model, backend, dev):
    """One dp×tp step of the flagship (fp32) against the single-device
    TrainStep on the same state and batch."""
    import copy

    import torch.distributed as dist

    from auto_dynamic_deeplab_torch.parallel import gather_train_state, make_mesh, make_tp_train_step, \
        shard_train_state
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer

    hw, batch = (TRAIN_HW, TRAIN_BATCH) if n_model == 1 else (SHARDED_TP_HW, SHARDED_TP_BATCH)
    g = torch.Generator(device=dev).manual_seed(9)
    image = torch.randn(batch, *hw, 3, generator=g, device=dev)
    label = torch.randint(0, 19, (batch, *hw), generator=g, device=dev)
    label[: batch // 2, : hw[0] // 2] = 255
    schedule = lr_schedule("poly", 0.05, 10, 4)
    single = _flagship().to(dev)
    model = copy.deepcopy(single)
    s_opt = make_optimizer(single.parameters())
    loss_single = TrainStep(single, s_opt, schedule)(image, label).item()
    single_bytes = _state_bytes(single, s_opt)
    want = {k: v.detach().to("cpu", copy=True) for k, v in single.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TrainStep(single, s_opt, schedule)(image, label).item()  # a second step, timed
    single_ms = (time.perf_counter() - t0) * 1e3
    del single, s_opt
    torch.cuda.empty_cache()
    mesh = make_mesh(n_data, n_model)
    opt = make_optimizer(model.parameters())
    shard_train_state(model, opt, mesh)
    step = make_tp_train_step(model, opt, schedule, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t0 = time.perf_counter()
    loss = step(image, label).item()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    tp_bytes = _state_bytes(model, opt)
    got = {k: v.cpu() for k, v in gather_train_state(model, opt)["model"].items()}
    names = [k for k, _ in model.named_parameters()]
    diff = torch.cat([(got[k].double() - want[k].double()).abs().reshape(-1) for k in names])
    bn = max(((got[k].double() - want[k].double()).abs() / (TP_TOL["bn_rtol"] * want[k].double().abs()
                                                            + TP_TOL["bn_atol"])).max().item()
             for k in want if k.endswith((".mean", ".var")))
    state_err = max((got[k].double() - want[k].double()).abs().max().item() / max(1.0, want[k].abs().max().item())
                    for k in want)
    sharded = sum(1 for m in model.modules() if getattr(m, "shard", None) is not None)
    dist.barrier()
    t0 = time.perf_counter()
    step(image, label)
    torch.cuda.synchronize()
    row = {"run": f"make_tp_train_step ({n_data}, {n_model}) ({backend})", "backend": backend,
           "mesh": [n_data, n_model], "rank": dist.get_rank(), "hw": list(hw), "batch": batch, "dtype": "float32",
           "loss": loss, "loss_single": loss_single, "loss_rel_err": abs(loss - loss_single) / abs(loss_single),
           "frac_above_2e-3": (diff > 2e-3).double().mean().item(), "max_param_diff": diff.max().item(),
           "bn_err_over_tol": bn, "state_err": state_err, "sharded_modules": sharded,
           "state_bytes_rank": tp_bytes, "state_bytes_unsharded": single_bytes, "peak_gb": peak / 2**30,
           "step_ms_first": first_ms, "step_ms_second": (time.perf_counter() - t0) * 1e3,
           "single_step_ms_second": single_ms,
           "tol": PARALLEL_TOL if n_model == 1 else TP_TOL}
    print(json.dumps({"phase": "sharded", **row}), flush=True)
    if n_model == 1:
        ok = row["loss_rel_err"] <= PARALLEL_TOL["loss"] and state_err <= PARALLEL_TOL["state"]
    else:
        ok = (row["loss_rel_err"] <= TP_TOL["loss"] and row["frac_above_2e-3"] < TP_TOL["frac_above_2e-3"]
              and row["max_param_diff"] < TP_TOL["max"] and bn <= 1.0 and tp_bytes < 0.75 * single_bytes)
    if not ok or sharded < 10:
        raise AssertionError(f"tensor-parallel step against the single-device step: {row}")
    return [row]


def _sharded_child():
    """One rank of phase 15 under the group the environment names
    (SHARDED_BACKEND: nccl, or gloo for two ranks on cuda:0): spatial
    sharding over the group, then the TP step on the (1, world) mesh."""
    import torch.distributed as dist

    from auto_dynamic_deeplab_torch.parallel import DataMesh, destroy, initialize
    from auto_dynamic_deeplab_torch.runtime import resolve_device

    backend = os.environ["SHARDED_BACKEND"]
    initialize(device="cuda" if backend == "nccl" else "cpu", timeout_s=600)
    dev = resolve_device("cuda")  # TF32 off
    torch.cuda.set_device(0)
    try:
        if dist.get_backend() != backend:
            raise AssertionError(f"want a {backend} group, got {dist.get_backend()}")
        _sharded_spatial(DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size()), backend, dev)
        _sharded_tp(1, dist.get_world_size(), backend, dev)
    finally:
        destroy()


class _RowSplit:
    """Rank 1 of a 3-way row split, in one process: ``fetch`` cuts the
    window it is asked for (inside the map: the block rule clips it) out
    of whichever of ``wholes`` holds the band, channels_last."""

    rank, world = 1, 3

    def __init__(self, wholes):
        self.wholes = wholes

    def band(self, rows, rank=None):
        r = self.rank if rank is None else rank
        return rows * r // self.world, rows * (r + 1) // self.world

    def fetch(self, x, rows, dim, window, fill):
        lo, hi = window(self.rank)
        whole = next(w for w in self.wholes if w.untyped_storage().data_ptr() == x.untyped_storage().data_ptr())
        return whole[:, :, lo:hi].contiguous(memory_format=torch.channels_last)


# K3-K6 on a row window: (kernel, a block whose route runs it, level); K5
# takes the per-op sep5 only in fp32 at C=160 (bf16 runs that block by K3)
WINDOW_BLOCKS = (
    ("block_stage", ("dil_conv_5x5", "sep_conv_3x3"), 1), ("sep_fused", ("max_pool_3x3", "sep_conv_3x3"), 1),
    ("sep_stage", ("sep_conv_5x5", "none"), 3), ("dense_stage", ("avg_pool_3x3", "dil_conv_5x5"), 2),
)
WINDOW_TOL = {"float32": 1e-6, "bfloat16": 1e-2}  # band rows against the whole map's kernel output


def _window_checks(ctx):
    """Each cell kernel (K3-K6) on the window of rows that the flat DAG's
    block rule (``band.block_windows``) fetches for the middle band of a
    3-way split, which starts mid-map, at the flagship's widths and sizes:
    its launches against the block's route, the band rows against the
    plain versions on the same window (phase 4's bounds) and against the
    whole map's kernel output (WINDOW_TOL; bitwise reported)."""
    import copy

    from auto_dynamic_deeplab_torch.kernels import cell_ops as co
    from auto_dynamic_deeplab_torch.ops import band
    from auto_dynamic_deeplab_torch.ops.primitives import OPS
    from auto_dynamic_deeplab_torch.utils.initialize import init_params, randomize_bn

    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for kernel, names, level in WINDOW_BLOCKS:
        c, h, w = CELL_SHAPES[level - 1]
        for dtype in (torch.float32,) if kernel == "sep_stage" else (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            route = co.block_route(names, c, dtype)
            gen = torch.Generator().manual_seed(60)
            ops = [randomize_bn(init_params(OPS[n](c, 1), gen), gen).cuda().eval() for n in names]
            xs = [torch.randn(1, h, w, c, generator=gen).to("cuda", dtype).permute(0, 3, 1, 2) for _ in names]
            fn = getattr(co, kernel)
            with torch.inference_mode():
                whole = torch.empty(1, h, w, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
                co._run_block(xs, names, ops, whole)
                split = _RowSplit(xs)
                lo, hi = split.band(h)
                wins, start = band.block_windows([x[:, :, lo:hi] for x in xs], h, split, names)
                dst = torch.empty(1, hi - lo, w, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
                before = fn.launches
                co._run_block(wins, names, ops, dst, start)
                torch.cuda.synchronize()
                launched = fn.launches - before
                plain = torch.empty(1, c, hi - lo, w, dtype=dtype)
                co._run_block([t.cpu() for t in wins], names, [copy.deepcopy(op).cpu() for op in ops], plain, start)
            got, band_rows = dst.double().cpu(), whole[:, :, lo:hi].double().cpu()
            row = {"kernel": kernel, "edges": list(names), "dtype": dname, "shape": [c, h, w], "band": [lo, hi],
                   "window": [lo - start, lo - start + wins[0].shape[2]], "launches": launched,
                   "launches_want": route.count(kernel),
                   "rel_err_plain": ((got - plain.double()).abs().max() / plain.double().abs().max()).item(),
                   "tol_plain": 1e-4 if dtype == torch.float32 else 2e-2,
                   "rel_err_whole": ((got - band_rows).abs().max() / band_rows.abs().max()).item(),
                   "tol_whole": WINDOW_TOL[dname], "bitwise_whole": torch.equal(got, band_rows)}
            emit({"phase": "sharded", "check": "window", **row, "nvidia_smi": ctx["smi"]})
            rows.append(row)
            if launched != row["launches_want"] or launched == 0 or not row["rel_err_plain"] <= row["tol_plain"] \
                    or not row["rel_err_whole"] <= row["tol_whole"]:
                raise AssertionError(f"{kernel} on a row window: {row}")
    return rows


def phase_sharded(ctx):
    """Spatial sharding and channel tensor parallelism: first K3-K6 on row
    windows in this process, then each rank a child process (as phase 13):
    world 1 over NCCL, and world 2 as two processes on cuda:0 over gloo
    (NCCL refuses two ranks on one GPU: compute stays on the card, the
    exchanged rows and gathers go through host copies)."""
    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    t_phase = time.perf_counter()
    _window_checks(ctx)
    total = Counter()
    for world, backend in ((1, "nccl"), (2, "gloo")):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", SHARDED_BACKEND=backend)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-child"],
                                  env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, (out, err) in zip(procs, outs):
            for line in out.splitlines():
                if line.startswith('{"phase": "sharded"'):
                    print(line, flush=True)
                    total.update(json.loads(line).get("launches", {}))
            if p.returncode != 0:
                raise AssertionError(f"phase 15 world {world} ({backend}) failed ({p.returncode}): {err[-6000:]}")
        emit({"phase": "sharded", "check": "seconds", "run": f"world {world} ({backend})",
              "seconds": time.perf_counter() - t0, "nvidia_smi": ctx["smi"]})
    spatial_runs = (2 + len(SHARDED_RUNS)) * (1 + 2)  # a rank's runs, over a world-1 and two world-2 ranks
    if total["fused_stems"] != spatial_runs:  # one K1 a rank an image
        raise AssertionError(f"phase 15 launched K1 {total['fused_stems']} times, want {spatial_runs}")
    missing = [name for name in CELL_KERNELS if total[name] == 0]
    if missing:
        raise AssertionError(f"phase 15 never launched {missing} on its sharded runs ({dict(total)})")
    ctx["sharded_launches"] = dict(total)
    emit({"phase": "sharded", "check": "seconds", "run": "phase 15", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": ctx["smi"]})


# phase 16: the JAX package's orbax run directory (tests/torch_orbax_fixture,
# recorded by scripts/torch_record_orbax_ref.py into tests/torch_orbax_ref.npz)
ORBAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "torch_orbax_fixture" / "synthetic"
ORBAX_REF = Path(__file__).resolve().parent / "tests" / "torch_orbax_ref.npz"
ORBAX_RUNS = {"stage2": ("ADD_C2_F4", "checkpoint"), "edm": ("edm_C2", "edm"),
              "search": ("search_net_supernet_F2", "checkpoint")}
ORBAX_SCHEDULE = ("poly", 0.01, 2, 5)  # the fixture's optimizer schedule
# logits 1e-3 of max|ref| and EDM confidences 1e-3 against the JAX-CPU
# recording (tests/test_torch_orbax.py); the resumed step: the loss 1e-5
# relative (test_train_step_on_gpu_matches_cpu's) against JAX's and the
# CPU's, the update within 5e-2 (L2, relative, over seeded projections) of
# JAX's and of the CPU's, as the CPU test holds it to JAX's, and the state
# after the step within 2e-2 of max(1, max|ref|) per tensor of the CPU's,
# the first-step test's bound across implementations: this ADD's step at
# 65x65 is ill-conditioned in its stems (the update 2.5e-2 from JAX's on
# the CPU)
RESTORE_TOL = {"logits_rel": 1e-3, "confidence": 1e-3, "loss": 1e-5, "update_rel": 5e-2, "card_vs_cpu_state": 2e-2}


def _ref_leaves(ref, key):
    out = {}
    for path, dt, shape, offset in json.loads(str(ref[f"leaves/{key}:index"])):
        blob = ref[f"leaves/{key}:{dt}"]
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        out[path] = blob[offset:offset + n].view(dt).reshape(shape)
    return out


def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, prefix + (str(k),))
    elif tree is not None:
        yield ".".join(prefix), tree


def _update_sketch(names, update):
    """Each tensor's update (float64) through 8 seeded Gaussian projections,
    tensor t's from RandomState(1000 + t), as the recorder projects JAX's."""
    return np.stack([np.random.RandomState(1000 + t).standard_normal((8, update[k].numel()))
                     @ update[k].reshape(-1).numpy() for t, k in enumerate(names)])


def _resumed_step(device, ckpt, image, label):
    """One step of the fixture's ADD on ``device`` after restoring its JAX
    train state: (loss, step, the model, each parameter's update)."""
    from auto_dynamic_deeplab_torch.models import ADD
    from auto_dynamic_deeplab_torch.nas import AUTODEEPLAB_GENOTYPE, NETWORK_ARCH
    from auto_dynamic_deeplab_torch.train.schedules import lr_schedule
    from auto_dynamic_deeplab_torch.train.step import TrainStep, make_optimizer
    from auto_dynamic_deeplab_torch.utils.initialize import init_params
    from auto_dynamic_deeplab_torch.utils.saver import restore_checkpoint

    cfg = NETWORK_ARCH[2]
    model = ADD(cfg["path"], cfg["C_index"], AUTODEEPLAB_GENOTYPE, 19, F=4, B=5,
                low_level_layer=cfg["low_level_layer"])
    model = init_params(model, torch.Generator().manual_seed(0)).to(device)
    step = TrainStep(model, make_optimizer(model.parameters()), lr_schedule(*ORBAX_SCHEDULE))
    step.load_state_dict(restore_checkpoint(str(ckpt), map_location=device)[0])
    before = {k: p.detach().double().cpu() for k, p in model.named_parameters()}
    loss = step(image.to(device), label.to(device)).item()
    update = {k: p.detach().double().cpu() - before[k] for k, p in model.named_parameters()}
    return loss, step.step, model, update


def phase_restore(ctx):
    """The JAX package's checkpoints on the card: the zstd decoder built,
    the committed run directory read (every leaf against the recording),
    the ADD and its EDM restored through cli.evaluate's build on cuda and
    evaluated static and dynamic, and one train step resumed."""
    from auto_dynamic_deeplab_torch.cli import evaluate
    from auto_dynamic_deeplab_torch.data import SyntheticSegmentation
    from auto_dynamic_deeplab_torch.utils import zstd
    from auto_dynamic_deeplab_torch.utils.orbax_reader import read_orbax_checkpoint

    if "smi" not in ctx:
        ctx["smi"] = nvidia_smi_line()
    t_phase = time.perf_counter()
    ref = dict(np.load(ORBAX_REF))
    t0 = time.perf_counter()
    zstd.get_lib()
    build_s = time.perf_counter() - t0
    paths = {key: ORBAX_FIXTURE / run / "experiment_0" / name for key, (run, name) in ORBAX_RUNS.items()}
    read_ms = {}
    for key, path in paths.items():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tree = read_orbax_checkpoint(str(path))
            times.append((time.perf_counter() - t0) * 1e3)
        got, want = dict(_tree_leaves(tree)), _ref_leaves(ref, key)
        if sorted(got) != sorted(want) or any(got[k].tobytes() != want[k].tobytes() for k in want):
            raise AssertionError(f"phase 16: {path} read differs from the recorded leaves")
        read_ms[key] = {"median_ms": statistics.median(times), "leaves": len(want),
                        "bytes": sum(f.stat().st_size for f in path.rglob("*") if f.is_file())}
    emit({"phase": "restore", "check": "read", "decoder_build_s": build_s, "read": read_ms,
          "bitwise_leaves": True, "cpu": _cpu_model(), "cores": os.cpu_count(), "nvidia_smi": ctx["smi"]})

    thr = float(ref["eval/threshold"])
    run = ORBAX_FIXTURE / "ADD_C2_F4" / "experiment_0"
    edm_run = ORBAX_FIXTURE / "edm_C2" / "experiment_0"
    argv = ["--F", "4", "--synthetic-crop", "65", "65", "--synthetic-length", str(int(ref["eval/length"])),
            "--workers", "4", "--dynamic", "--confidence", "edm", "--threshold", repr(thr),
            "--resume", str(run), "--edm-resume", str(edm_run)]
    kernels = _all_kernels()
    total = Counter()
    evaluation, loader = evaluate.build(evaluate.build_parser().parse_args(argv))
    images = np.concatenate([b["image"] for b in loader])
    n = len(images)
    if hashlib.sha256(np.ascontiguousarray(images)).hexdigest() != str(ref["eval/sha256"]):
        raise AssertionError("phase 16: the validation images differ from the recorded ones")
    # static validation: one K1 an image and one K2 an exit
    for f in kernels.values():
        f.launches = 0
    static = evaluation.validate(loader)
    counts = _counts(kernels)
    if counts["fused_stems"] != n or counts["entropy_argmax_triton"] != 2 * n:
        raise AssertionError(f"phase 16 static validation launched {counts}, want K1 {n}, K2 {2 * n}")
    total.update(counts)
    refs = [ref[f"eval/logits_{k}"] for k in range(2)]
    with torch.inference_mode():
        outs = evaluation.model.eval()(torch.from_numpy(images[:len(refs[0])]).cuda())
    logits_err = [float(np.abs(o.float().cpu().numpy() - r).max() / np.abs(r).max()) for o, r in zip(outs, refs)]
    # the dynamic segment loop: one K1 an image and one for its warm-up, the EDM decides
    for f in kernels.values():
        f.launches = 0
    seg = evaluation.dynamic_inference(loader, threshold=thr, confidence="edm", fused=False)
    counts = _counts(kernels)
    want_hist = np.bincount(ref["eval/exit"], minlength=2).tolist()
    if counts["fused_stems"] != n + 1 or counts["entropy_argmax_triton"] != 0 or seg["exit_histogram"] != want_hist:
        raise AssertionError(f"phase 16 segment loop: {seg}, launches {counts}; want K1 {n + 1}, exits {want_hist}")
    total.update(counts)
    conf_err, exits = [], []
    for i in range(n):
        lg, k, _, conf = evaluation.engine.infer_fused(images[i:i + 1], thr, "edm")
        exits.append(int(k))
        conf_err.append(abs(conf - float(ref["eval/dynamic_confidence"][i])))
        if i < len(refs[0]):
            r = refs[k][i]
            logits_err.append(float(np.abs(lg[0].permute(1, 2, 0).float().cpu().numpy() - r).max() / np.abs(r).max()))
    cli_stats = evaluate.main(argv)  # the CLI's --dynamic: the fused graphs
    row = {"run": "cli.evaluate --resume --edm-resume (the JAX run)", "hw": [65, 65], "n_images": n,
           "static_miou": static["miou"], "logits_max_rel_err": max(logits_err),
           "confidence_max_abs_err": max(conf_err), "exits": exits, "exits_want": ref["eval/exit"].tolist(),
           "cli_exit_histogram": cli_stats["exit_histogram"], "launches": dict(total), "tol": RESTORE_TOL,
           "nvidia_smi": ctx["smi"]}
    emit({"phase": "restore", **row})
    if not (max(logits_err) <= RESTORE_TOL["logits_rel"] and max(conf_err) <= RESTORE_TOL["confidence"]
            and exits == ref["eval/exit"].tolist() and cli_stats["exit_histogram"] == want_hist):
        raise AssertionError(f"phase 16: the restored JAX run disagrees with the JAX-CPU recording: {row}")
    del evaluation

    # one train step from the JAX train state, on the card and on the CPU
    data = SyntheticSegmentation(4, (65, 65), 19, seed=7)
    image = torch.from_numpy(np.stack([data[i]["image"] for i in range(4)]))
    label = torch.from_numpy(np.stack([data[i]["label"] for i in range(4)]))
    ckpt = run / "checkpoint"
    card_loss, card_step, card_model, card_update = _resumed_step("cuda", ckpt, image, label)
    cpu_loss, _, cpu_model, cpu_update = _resumed_step("cpu", ckpt, image, label)
    names = json.loads(str(ref["step/names"]))
    want = ref["step/update_sketch"]
    card_sketch, cpu_sketch = _update_sketch(names, card_update), _update_sketch(names, cpu_update)
    update_rel = float(np.linalg.norm(card_sketch - want) / np.linalg.norm(want))
    update_rel_cpu = float(np.linalg.norm(card_sketch - cpu_sketch) / np.linalg.norm(cpu_sketch))
    cpu_state = cpu_model.state_dict()
    state_errs = {k: (t.detach().cpu().double() - cpu_state[k].double()).abs().max().item()
                  / max(1.0, cpu_state[k].abs().max().item()) for k, t in card_model.state_dict().items()}
    worst = max(state_errs, key=state_errs.get)
    jax_loss = float(ref["step/loss"])
    row = {"run": "train step resumed from the JAX train state (batch 4, 65x65, fp32)", "loss_card": card_loss,
           "loss_cpu": cpu_loss, "loss_jax": jax_loss, "loss_rel_err_jax": abs(card_loss - jax_loss) / jax_loss,
           "loss_rel_err_cpu": abs(card_loss - cpu_loss) / cpu_loss, "update_rel_err_jax": update_rel,
           "update_rel_err_cpu": update_rel_cpu, "state_err_cpu": state_errs[worst], "state_err_cpu_tensor": worst,
           "step": card_step, "step_want": int(ref["step/step"]),
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": ctx["smi"]}
    emit({"phase": "restore", **row})
    if not (row["loss_rel_err_jax"] <= RESTORE_TOL["loss"] and row["loss_rel_err_cpu"] <= RESTORE_TOL["loss"]
            and max(update_rel, update_rel_cpu) <= RESTORE_TOL["update_rel"]
            and row["state_err_cpu"] <= RESTORE_TOL["card_vs_cpu_state"]
            and card_step == row["step_want"]):
        raise AssertionError(f"phase 16: the resumed train step disagrees: {row}")
    missing = [k for k in ("fused_stems", "entropy_argmax_triton") if total[k] == 0]
    if missing:
        raise AssertionError(f"phase 16 never launched {missing}")
    ctx["restore_launches"] = dict(total)
    emit({"phase": "restore", "check": "seconds", "seconds": time.perf_counter() - t_phase, "nvidia_smi": ctx["smi"]})


def _cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def phase_kernels(ctx):
    """The kernels line; a run of a subset of the phases lists the kernels
    whose checks (phases 2-4) ran."""
    k1, k2, cells = ctx.get("k1"), ctx.get("k2"), ctx.get("cells", {})
    launches = ctx.get("launches", {})

    def entry(name, route, source, replaces, main, other):
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "train_path_launches": ctx.get("train_launches", {}).get(name, 0),
            "search_path_launches": ctx.get("search_launches", {}).get(name, 0),
            "data_path_launches": ctx.get("data_launches", {}).get(name, 0),
            "parallel_path_launches": ctx.get("parallel_launches", {}).get(name, 0),
            "variants_path_launches": ctx.get("variants_launches", {}).get(name, 0),
            "sharded_path_launches": ctx.get("sharded_launches", {}).get(name, 0),
            "restore_path_launches": ctx.get("restore_launches", {}).get(name, 0),
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main.get("library_ms"), "dtype": main["dtype"],
            "shape": main.get("shape"), "bf16_ms": other["ms"], "bf16_plain_ms": other["plain_ms"],
            "bf16_bound_ms": other["bound_ms"], "bf16_max_abs_err": other["max_abs_err"],
            "bf16_library_ms": other.get("library_ms"),
        }

    cu = "auto_dynamic_deeplab_torch/csrc/cell_ops.cu"
    tpu = "auto_dynamic_deeplab_tpu/kernels/cell_ops.py"
    # the main path (cli.evaluate) runs the fp32 policy; bf16 is bench.py's
    rows = []
    if k1:
        rows.append(entry("fused_stems", "cuda", "auto_dynamic_deeplab_torch/csrc/stems.cu",
                          "auto_dynamic_deeplab_tpu/kernels/stems.py:266", k1["float32"], k1["bfloat16"]))
    if k2:
        rows.append(entry("entropy_argmax_triton", "triton",
                          "auto_dynamic_deeplab_torch/kernels/_entropy_argmax_triton.py",
                          "auto_dynamic_deeplab_tpu/kernels/confidence.py:47", k2["float32"], k2["bfloat16"]))
    for name, line in (("block_stage", 765), ("sep_fused", 385), ("sep_stage", 466), ("dense_stage", 495)):
        if name in cells:
            rows.append(entry(name, "cuda", cu, f"{tpu}:{line}", cells[name]["float32"], cells[name]["bfloat16"]))
    print(json.dumps({"kernels": rows}), flush=True)


PHASES = {
    1: phase_device, 2: phase_k1, 3: phase_k2, 4: phase_cells, 5: phase_model,
    6: phase_main_path, 7: phase_engine, 8: phase_trained, 9: phase_kernels, 10: phase_train,
    11: phase_search, 12: phase_input_pipeline, 13: phase_parallel, 14: phase_variants, 15: phase_sharded,
    16: phase_restore,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="1,2,3,4,5,6,7,8,10,11,12,13,14,15,16,9")
    p.add_argument("--parallel-child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sharded-child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU", file=sys.stderr)
        return 2
    if args.parallel_child:
        _parallel_child()
        return 0
    if args.sharded_child:
        _sharded_child()
        return 0
    phases = [int(v) for v in args.phases.split(",")]
    ctx = {}
    t0 = time.perf_counter()
    by_phase = {}
    for k in phases:
        if k == 9:
            emit({"phase": "elapsed", "seconds": time.perf_counter() - t0, "by_phase": by_phase})
        t = time.perf_counter()
        PHASES[k](ctx)
        by_phase[k] = time.perf_counter() - t
    print(ctx.get("smi") or nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
