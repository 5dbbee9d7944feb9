"""Evaluation drivers (train/evaluator.py of the JAX package; the
reference's eval.py Evaluation, :29-230).

Static mode: per-exit mIoU over the val set, with the per-exit entropy and
argmax from K2 on CUDA logits. Dynamic mode: per-image early-exit inference
reporting mIoU, mean latency, fps, early-exit rate and average confidence.
As in the JAX package it runs the single-program mode by default
(``fused=True``: ``engine.infer_fused``, one CUDA graph a segment on the
card), timing the first image twice and keeping the second; ``fused=False``
runs the engine's eager segment loop after a warm-up. The exit decisions
and mIoU of the two are the same. The average confidence is each image's
first decision's, which is what the fused program returns (its
``descend`` carries the current stage's value up), in both modes;
``DynamicInferenceEngine.infer`` returns the last decision's, as JAX
``infer`` does. The two differ from three exits on. ``pipeline_devices``
>= 2 runs the segment loop split over that many devices
(``parallel.pipeline.PipelinedDynamicInference``), whose confidence is the
last decision's, as the JAX evaluator reports it there.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..kernels.confidence import entropy_argmax
from ..utils.meters import AverageMeter
from ..utils.metrics import Evaluator
from .dynamic import DynamicInferenceEngine


class Evaluation:
    """Runs on ``device`` (cuda unless the caller asks for the CPU)."""

    def __init__(self, model, num_classes: int, edm=None, device="cuda"):
        self.engine = DynamicInferenceEngine(model, edm=edm, num_classes=num_classes, device=device)
        self.model, self.edm, self.device = self.engine.model, self.engine.edm, self.engine.device
        self.num_classes = num_classes

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor):
        """Per-exit (argmax (N, H, W), normalized entropy (N,))."""
        preds, confs = [], []
        for logits in self.model(x, class_leading=True):
            ent, arg = entropy_argmax(logits, self.num_classes, class_axis=1)
            preds.append(arg)
            confs.append(ent)
        return preds, confs

    # ------------------------------------------------------------- static

    def validate(self, loader) -> Dict:
        """Per-exit mIoU + mean entropy confidence (train.py:278-297), with
        the model's weights as they are now (the trainer's ``Evaluation``
        outlives its optimizer steps and leaves the model in eval mode)."""
        self.model.eval()
        n_exits = len(self.model.exit_layers)
        evaluators = [Evaluator(self.num_classes, self.device) for _ in range(n_exits)]
        conf_meters = [AverageMeter() for _ in range(n_exits)]
        for batch in loader:
            x = torch.as_tensor(batch["image"]).to(self.device)
            labels = torch.as_tensor(batch["label"]).to(self.device)
            preds, confs = self._forward(x)
            for k in range(n_exits):
                evaluators[k].add_batch(labels, preds[k])
                for c in confs[k].tolist():
                    conf_meters[k].update(c)
        return {
            "miou": [e.Mean_Intersection_over_Union() for e in evaluators],
            "pixel_acc": [e.Pixel_Accuracy() for e in evaluators],
            "confidence": [m.avg for m in conf_meters],
        }

    # ------------------------------------------------------------ dynamic

    def dynamic_inference(
        self,
        loader,
        threshold: float = 0.0,
        confidence: str = "edm",
        warmup_shape=None,
        fused: bool = True,
        pipeline_devices: int = 0,
    ) -> Dict:
        def segment_loop(x, threshold, confidence):
            logits, exit_idx, dt, confs = self.engine._infer(x, threshold, confidence)
            return logits, exit_idx, dt, confs[0] if confs else float("nan")

        if pipeline_devices >= 2:
            infer, fused = self._pipelined(pipeline_devices), False
        else:
            infer = self.engine.infer_fused if fused else segment_loop
            if warmup_shape is not None and not fused:
                self.engine.warmup(warmup_shape, confidence, threshold)
        evaluator = Evaluator(self.num_classes, self.device)
        latency = AverageMeter()
        conf_meter = AverageMeter()
        n_images = 0
        early_exits = 0
        exit_histogram = [0] * len(self.model.exit_layers)

        warmed = fused or warmup_shape is not None or pipeline_devices >= 2
        first = fused
        for batch in loader:
            images, labels = batch["image"], batch["label"]
            for i in range(images.shape[0]):
                x = images[i : i + 1]
                if not warmed:
                    self.engine.warmup(x.shape, confidence, threshold)
                    warmed = True
                logits, exit_idx, dt, conf = infer(x, threshold, confidence)
                if first:  # the first fused call captures its graphs: time it again
                    logits, exit_idx, dt, conf = infer(x, threshold, confidence)
                    first = False
                pred = logits.argmax(dim=1)[0].to(self.device)  # (N, C, H, W) logits
                evaluator.add_batch(torch.as_tensor(labels[i]).to(self.device), pred)
                latency.update(dt)
                if not np.isnan(conf):
                    conf_meter.update(conf)
                exit_histogram[exit_idx] += 1
                early_exits += int(exit_idx < len(self.model.exit_layers) - 1)
                n_images += 1

        return {
            "miou": evaluator.Mean_Intersection_over_Union(),
            "mean_latency_s": latency.avg,
            "fps": 1.0 / max(latency.avg, 1e-12),
            "early_exit_rate": early_exits / max(n_images, 1),
            "avg_confidence": conf_meter.avg,
            "exit_histogram": exit_histogram,
            "n_images": n_images,
        }

    def _pipelined(self, n: int):
        """infer(x, threshold, confidence) through a pipeline over ``n``
        devices: ``cuda:0``..``cuda:n-1`` (raises with fewer GPUs, where the
        pipeline would silently take fewer stages), or ``n`` stages on the
        CPU. One pipeline per input size, warmed up when built."""
        from ..parallel.pipeline import PipelinedDynamicInference

        if self.device.type == "cuda":
            if torch.cuda.device_count() < n:
                raise RuntimeError(
                    f"pipeline_devices={n} requested but only {torch.cuda.device_count()} GPUs are visible"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [self.device] * n
        pipes = {}

        def infer(x, threshold, confidence):
            size = tuple(x.shape[1:3])
            if size not in pipes:
                pipes[size] = PipelinedDynamicInference(
                    self.model, size, devices, confidence, threshold, edm=self.edm, num_classes=self.num_classes)
                pipes[size].warmup()
            pipe = pipes[size]
            pipe.synchronize()
            t0 = time.perf_counter()
            logits, exit_idx, conf = pipe.infer(x)
            pipe.synchronize()
            return logits, exit_idx, time.perf_counter() - t0, conf

        return infer
