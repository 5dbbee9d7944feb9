"""Stage-2 trainer (train/trainer.py of the JAX package; the reference's
train.py trainNew, :34-322): the loaders → the train step →
per-epoch validation (per-exit mIoU and mean entropy confidence) → a
checkpoint with best-mIoU promotion → scalar summaries.

Under a process group (``parallel.distributed.initialize``) and
``data_parallel`` the step is data-parallel (``parallel/mesh.py``): every
rank reads the global batch, keeps its own rows and averages the
gradients over the ranks; without a group it runs on one device. Rank 0
alone writes the checkpoints, the summaries and the experiment config;
every rank validates the whole validation set with rank 0's weights and
BN statistics (the JAX step keeps shard 0's statistics), so every rank
reports the same mIoU.

Validation runs the eval path, K1 and K2 on the card, through one
``Evaluation`` built at the first validation and reused: it holds the
model itself, so it reads the weights as the optimizer left them (the
kernels' folded-weight caches key on the tensors' versions, which the
optimizer's and the BNs' in-place updates bump). It validates in static
mode only: a CUDA graph of the fused dynamic mode bakes in K1's packed
weights at capture.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import data_shard
from ..parallel.mesh import make_data_mesh, replicate, shard_batch
from ..runtime import resolve_device
from ..utils.saver import Saver, checkpoint_path, find_latest_checkpoint, restore_checkpoint
from ..utils.summaries import TrainingSummary
from .evaluator import Evaluation
from .schedules import lr_schedule
from .step import TrainStep, make_optimizer


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    lr: float = 0.05
    lr_scheduler: str = "poly"
    min_lr: Optional[float] = None
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 4e-5
    eval_interval: int = 10  # <= 0: no validation (the reference's --no-val)
    use_balanced_weights: bool = False
    run_dir: str = "run"
    dataset: str = "synthetic"
    checkname: str = "add"
    # 'auto': the newest committed checkpoint of this run_dir/dataset/
    # checkname (preemption recovery; a cold start when there is none), or
    # a checkpoint (a port file or the JAX package's orbax directory) or the
    # experiment directory holding one (the reference's --resume,
    # train.py:184-210)
    resume: Optional[str] = None
    # with resume: the weights only, the schedule restarts from epoch 0
    # (the reference's --ft, train.py:212-214)
    ft: bool = False
    # the train loader yields raw uint8 batches ({"image_u8", "label_u8"}),
    # flipped, scaled, cropped to crop_size and normalized on the device
    # (data/device_transforms.py)
    device_augment: bool = False
    crop_size: Optional[Tuple[int, int]] = None
    # under a process group: the data-parallel step (False there raises);
    # without a group it has no effect
    data_parallel: bool = True


class _StepClock:
    """Each training step's time in ms, from the end of the one before
    (the first from the epoch's start): CUDA events on the card, read at
    the epoch's end, so the loop never waits for the device; the host's
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        if self.cuda:
            if self.marks:
                self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class Trainer:
    """Trains ``model`` (initialized by the caller) on ``device`` (cuda
    unless the caller asks for the CPU; raises without a GPU). ``seed``
    seeds the device augmentation's draws."""

    def __init__(
        self,
        model,
        train_loader,
        val_loader,
        config: TrainConfig,
        class_weight: Optional[np.ndarray] = None,
        device="cuda",
        seed: int = 0,
    ):
        if config.device_augment and config.crop_size is None:
            raise ValueError(
                "device_augment=True requires crop_size (the augmented shape; raw uint8 batches "
                "carry the source canvas shape)"
            )
        self.device = resolve_device(device)
        self.mesh = _data_mesh(train_loader.batch_size, config.data_parallel)
        self.n_shards = self.mesh.world if self.mesh else 1
        self._seed = seed
        self._augment = None  # built from the first raw batch
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.best_pred = 0.0
        self.step_ms: List[float] = []  # the last training epoch's step times

        schedule = lr_schedule(
            config.lr_scheduler, config.lr, config.epochs, max(len(train_loader), 1), min_lr=config.min_lr
        )
        optimizer = make_optimizer(
            self.model.parameters(), config.momentum, config.nesterov, config.weight_decay
        )
        self.train_step = TrainStep(self.model, optimizer, schedule, class_weight, mesh=self.mesh)

        self.start_epoch = 0
        self._evaluation = None  # built at the first validation, then reused
        if config.resume:
            self._resume(config.resume, ft=config.ft)
        if self.mesh is not None:
            replicate(self.model, self.mesh)  # every rank starts from rank 0's weights

        self.saver, self.summary = _writers(config, self.mesh)
        self.experiment_dir = _shared_experiment_dir(self.saver, self.mesh)

    def _scalar(self, tag: str, value: float, step: int):
        if self.summary is not None:
            self.summary.add_scalar(tag, value, step)

    def _resume(self, resume: str, ft: bool = False):
        """Restore the weights, BN statistics, optimizer and step from a
        committed checkpoint, the port's or the JAX package's; with ``ft``
        only the weights and statistics, and the schedule restarts."""
        path = resume
        if resume == "auto":
            path = find_latest_checkpoint(self.config.run_dir, self.config.dataset, self.config.checkname)
            if path is None:
                return  # cold start: nothing committed yet
        else:
            path = checkpoint_path(path)
        state, meta = restore_checkpoint(path, map_location=self.device)
        self.train_step.load_state_dict(state, weights_only=ft)
        if not ft:
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_pred = float(meta.get("best_pred", 0.0))

    def _device_augment(self, batch, epoch: int, b: int, rows=None):
        """A raw uint8 batch → (image, label) augmented on the device. Sample
        k of batch b draws from ``RandomState(seed·7919 + epoch·613 + b·127
        + k)``, k its row in the global batch (``rows``: this rank's; all of
        them by default), so the draws are fixed by (seed, epoch, batch)
        whatever the world."""
        from ..data.device_transforms import augment_batch, make_train_augment

        src_hw = batch["image_u8"].shape[1:3]
        if self._augment is None:
            self._augment = make_train_augment(src_hw, self.config.crop_size, device=self.device)
        base = self._seed * 7919 + epoch * 613
        rows = range(batch["image_u8"].shape[0]) if rows is None else rows
        rngs = [np.random.RandomState(base + b * 127 + k) for k in rows]
        return augment_batch(self._augment, batch["image_u8"], batch["label_u8"], src_hw,
                             self.config.crop_size, rngs=rngs)

    def training(self, epoch: int) -> float:
        self.train_loader.set_epoch(epoch)
        losses = []
        clock = _StepClock(self.device)
        clock.mark()
        for b, batch in enumerate(self.train_loader):
            n = next(iter(batch.values())).shape[0]
            if n % self.n_shards:
                continue  # a ragged tail the ranks cannot share (JAX drops it too)
            rows = range(n)
            if self.mesh is not None:
                rows = rows[self.mesh.rows(n)]
                batch = shard_batch(batch, self.mesh)
            if self.config.device_augment and "image_u8" in batch:
                image, label = self._device_augment(batch, epoch, b, rows)
            else:
                image = torch.as_tensor(batch["image"]).to(self.device)
                label = torch.as_tensor(batch["label"]).to(self.device)
            losses.append(self.train_step(image, label))
            clock.mark()
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        self.step_ms = clock.step_ms()
        self._scalar("train/total_loss_epoch", train_loss, epoch)
        if len(self.step_ms) > 1:
            self._scalar("train/step_ms_median", float(np.median(self.step_ms[1:])), epoch)
        return train_loss

    def validation(self, epoch: int) -> dict:
        if self.mesh is not None:
            replicate(self.model, self.mesh)  # rank 0's BN statistics (the same without --sync-bn)
        if self._evaluation is None:
            self._evaluation = Evaluation(self.model, self.model.num_classes, device=self.device)
        result = self._evaluation.validate(self.val_loader)
        for k, miou in enumerate(result["miou"]):
            self._scalar(f"val/mIoU_exit_{k}", miou, epoch)
            self._scalar(f"val/confidence_exit_{k}", result["confidence"][k], epoch)
        mean_miou = float(np.mean(result["miou"]))
        is_best = mean_miou > self.best_pred
        if is_best:
            self.best_pred = mean_miou
        if self.saver is not None:
            self.saver.save_checkpoint(self.train_step.state_dict(), is_best, epoch, self.best_pred)
        return result

    def fit(self, epochs: Optional[int] = None) -> dict:
        """Epochs from ``start_epoch``; validates every ``eval_interval``
        epochs and after the last. Returns the last validation's result
        with ``train_loss`` and that epoch's ``step_ms``."""
        epochs = epochs or self.config.epochs
        result = {}
        for epoch in range(self.start_epoch, epochs):
            loss = self.training(epoch)
            if self.config.eval_interval > 0 and (
                (epoch + 1) % self.config.eval_interval == 0 or epoch == epochs - 1
            ):
                result = self.validation(epoch)
                result["train_loss"] = loss
                result["step_ms"] = self.step_ms
        return result


def _data_mesh(batch_size: int, data_parallel: bool):
    """The data mesh of the default process group when ``data_parallel``
    (None without a group); raises when a multi-rank group would have
    every rank train alone."""
    world = data_shard()[1]
    if world > 1 and not data_parallel:
        raise ValueError(
            f"data_parallel=False (--no-data-parallel / --no-dp) under a {world}-rank process group: "
            "every rank would train its own copy; run one process, or drop the flag"
        )
    return make_data_mesh(batch_size) if data_parallel else None


def _writers(config, mesh):
    """(Saver, TrainingSummary) of a run, on rank 0 only ((None, None)
    elsewhere): the new experiment directory, its parameters.txt and its
    scalars."""
    if mesh is not None and mesh.rank != 0:
        return None, None
    saver = Saver(config.run_dir, config.dataset, config.checkname)
    saver.save_experiment_config(dataclasses.asdict(config))
    return saver, TrainingSummary(saver.experiment_dir)


def _shared_experiment_dir(saver, mesh) -> str:
    """Rank 0's experiment directory, on every rank."""
    if mesh is None:
        return saver.experiment_dir
    out = [saver.experiment_dir if saver is not None else None]
    torch.distributed.broadcast_object_list(out, group=mesh.group)
    return out[0]
