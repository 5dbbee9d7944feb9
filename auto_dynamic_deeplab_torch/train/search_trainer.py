"""Stage-1 NAS search trainer (train/search_trainer.py of the JAX package;
the reference's search.py Trainer, :43-327).

Bilevel alternating optimization on two disjoint train halves:
  * weight step (loader A): SGD with momentum 0.9 (no Nesterov) and the
    decay in the gradient, at the cos schedule's lr for the update count,
    on the weights, with the per-exit CE;
  * arch step (loader B, cycled, from ``alpha_epoch`` on): Adam on alphas /
    betas with the same loss (search.py:203-224).
Both steps run training-mode BN. Each validation takes the eval-mode
argmax per exit into an mIoU, decodes the architecture (Viterbi + genotype,
``nas/decode.py``) into ``arch_epoch_{e}/`` and writes a checkpoint with
both optimizers' states (search.py:296-327).

With a ``DataMesh`` (the JAX trainer's ``mesh``; the reference searches
under DataParallel + SyncBN, search.py:144-149) both steps are
data-parallel: every rank reads the global batches, keeps its own rows
and averages each step's gradients over the ranks, and a batch the ranks
cannot share evenly is skipped, as the JAX trainer skips it. The caller
gives the supernet's BNs the mesh's group (``ops.norm.set_bn_group``), as
JAX builds them with ``axis_name=DATA_AXIS``. Rank 0 alone writes; every
rank validates the whole validation set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nas.decode import genotype_decode, viterbi_decode
from ..parallel.mesh import DataMesh, replicate, shard_batch
from ..runtime import resolve_device
from ..utils.metrics import Evaluator
from ..utils.saver import checkpoint_path, find_latest_checkpoint, restore_checkpoint
from .schedules import lr_schedule
from .step import SearchSteps, make_arch_optimizer, make_optimizer
from .trainer import _shared_experiment_dir, _StepClock, _writers


@dataclasses.dataclass
class SearchConfig:
    """Defaults are the PUBLISHED recipe (scripts/search_cityscapes.sh in the
    reference: lr 0.05 / min 0.003 cos, weight decay 8e-4, arch lr 1e-3),
    not the reference's argparse defaults (search.py:360-362), which its
    shipped scripts always override; the CLI keeps the argparse ones."""
    epochs: int = 300
    alpha_epoch: int = 150        # arch updates start here (search.py:203)
    lr: float = 0.05
    min_lr: float = 0.003
    lr_scheduler: str = "cos"
    momentum: float = 0.9
    weight_decay: float = 8e-4
    arch_lr: float = 1e-3
    arch_weight_decay: float = 1e-3
    eval_interval: int = 5        # <= 0: no validation (the reference's --no-val)
    # per-exit CE reduction: 'mean' (search.py:190-194) or 'sum'
    # (search_layer.py:187-196, the 2-exit search)
    loss_reduce: str = "mean"
    run_dir: str = "run"
    dataset: str = "synthetic"
    checkname: str = "search"
    # 'auto': the newest committed checkpoint of this run_dir/dataset/
    # checkname (a cold start when there is none), or a checkpoint file or
    # the experiment directory holding one (search.py:104-116)
    resume: Optional[str] = None


class SearchTrainer:
    """Searches with ``model`` (a ``TrellisSupernet``, initialized by the
    caller) on ``device`` (cuda unless the caller asks for the CPU; raises
    without a GPU); data-parallel over ``mesh`` when one is given."""

    def __init__(
        self,
        model,
        loader_a,
        loader_b,
        val_loader,
        config: SearchConfig,
        class_weight: Optional[np.ndarray] = None,
        device="cuda",
        mesh: Optional[DataMesh] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_shards = mesh.world if mesh is not None else 1
        self.model = model.to(self.device)
        self.loader_a, self.loader_b, self.val_loader = loader_a, loader_b, val_loader
        self.config = config
        self.best_pred = 0.0
        # the last training epoch's step times, ms, and weight-step losses
        self.step_ms: Dict[str, List[float]] = {"weight": [], "arch": []}
        self.step_losses: List[float] = []

        schedule = lr_schedule(
            config.lr_scheduler, config.lr, config.epochs, max(len(loader_a), 1), min_lr=config.min_lr
        )
        w_opt = make_optimizer(model.weight_parameters(), config.momentum, nesterov=False,
                               weight_decay=config.weight_decay)
        a_opt = make_arch_optimizer(model.arch_parameters(), config.arch_lr, config.arch_weight_decay)
        self.steps = SearchSteps(model, w_opt, a_opt, schedule, class_weight, config.loss_reduce, mesh=mesh)

        self.start_epoch = 0
        if config.resume:
            self._resume(config.resume)
        if mesh is not None:
            replicate(self.model, mesh)  # every rank starts from rank 0's weights and arch

        self.saver, self.summary = _writers(config, mesh)
        self.experiment_dir = _shared_experiment_dir(self.saver, mesh)

    def _scalar(self, tag: str, value: float, step: int):
        if self.summary is not None:
            self.summary.add_scalar(tag, value, step)

    def _resume(self, resume: str):
        """Restore the weights, BN statistics, arch, both optimizers, the
        epoch and best_pred from a committed checkpoint, the port's or the
        JAX package's."""
        path = resume
        if resume == "auto":
            path = find_latest_checkpoint(self.config.run_dir, self.config.dataset, self.config.checkname)
            if path is None:
                return  # cold start: nothing committed yet
        else:
            path = checkpoint_path(path)
        state, meta = restore_checkpoint(path, map_location=self.device)
        self.steps.load_state_dict(state)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_pred = float(meta.get("best_pred", 0.0))

    def _to_device(self, batch):
        return (torch.as_tensor(batch["image"]).to(self.device), torch.as_tensor(batch["label"]).to(self.device))

    def _rows(self, batch):
        """This rank's rows of a global training batch, on the device."""
        return self._to_device(batch if self.mesh is None else shard_batch(batch, self.mesh))

    def _next_b(self, iter_b):
        """(batch, iterator) of loader B, which cycles, skipping batches the
        ranks cannot share evenly."""
        for _ in range(len(self.loader_b) + 1):  # bounded: every B batch ragged
            try:
                batch = next(iter_b)
            except StopIteration:
                iter_b = iter(self.loader_b)
                try:
                    batch = next(iter_b)
                except StopIteration:
                    raise RuntimeError(
                        f"loader_b yields no batches: the arch half of the search split "
                        f"({len(self.loader_b.dataset)} samples) is smaller than one batch "
                        f"({self.loader_b.batch_size}): shrink the batch or grow the dataset"
                    ) from None
            if batch["image"].shape[0] % self.n_shards == 0:
                return batch, iter_b
        raise RuntimeError(f"no loader_b batch divides the {self.n_shards}-shard mesh")

    def training(self, epoch: int) -> float:
        self.loader_a.set_epoch(epoch)
        self.loader_b.set_epoch(epoch)
        bilevel = epoch >= self.config.alpha_epoch
        iter_b = iter(self.loader_b) if bilevel else None
        losses = []
        clock, kinds = _StepClock(self.device), []
        clock.mark()
        for batch in self.loader_a:
            if batch["image"].shape[0] % self.n_shards:
                continue  # a ragged tail smaller than the mesh
            losses.append(self.steps.weight_step(*self._rows(batch)))
            clock.mark()
            kinds.append("weight")
            if bilevel:
                batch_b, iter_b = self._next_b(iter_b)
                self.steps.arch_step(*self._rows(batch_b))
                clock.mark()
                kinds.append("arch")
        if iter_b is not None:
            iter_b.close()  # stops its prefetch thread
        if not losses:
            raise RuntimeError(
                f"epoch {epoch}: loader A yields no batches"
                + (f" that divide the {self.n_shards}-shard mesh (every batch was dropped as a ragged "
                   "tail: the batch size must be a multiple of the world size)" if self.n_shards > 1 else "")
            )
        times = clock.step_ms()
        self.step_ms = {k: [t for t, kind in zip(times, kinds) if kind == k] for k in ("weight", "arch")}
        losses = torch.stack(losses)
        self.step_losses = losses.tolist()
        train_loss = float(losses.mean())
        self._scalar("search/train_loss", train_loss, epoch)
        return train_loss

    def validation(self, epoch: int) -> dict:
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        n_exits = len(self.model.exit_stations)
        evaluators = [Evaluator(self.model.num_classes, device=self.device) for _ in range(n_exits)]
        self.model.eval()
        with torch.no_grad():
            for batch in self.val_loader:
                image, label = self._to_device(batch)
                for ev, logits in zip(evaluators, self.model(image, class_leading=True)):
                    ev.add_batch(label, logits.argmax(dim=1))
        mious = [e.Mean_Intersection_over_Union() for e in evaluators]
        for k, m in enumerate(mious):
            self._scalar(f"search/mIoU_exit_{k}", m, epoch)
        mean_miou = float(np.mean(mious))
        is_best = mean_miou > self.best_pred
        if is_best:
            self.best_pred = mean_miou
        self.decode_and_save(epoch)
        if self.saver is not None:
            self.saver.save_checkpoint(self.steps.state_dict(), is_best, epoch, self.best_pred)
        return {"miou": mious}

    def decode_and_save(self, epoch: int) -> dict:
        """Viterbi + genotype decode of the current arch (search.py:296-327),
        written by rank 0."""
        betas = self.model.betas.detach().float().cpu().numpy()
        path, space = viterbi_decode(betas)
        genotype = None
        if self.model.cell_kind == "mixed":
            genotype = genotype_decode(self.model.alphas.detach().float().cpu().numpy(), self.model.B)
        if self.saver is not None:
            self.saver.save_architecture(epoch, path, betas=betas, genotype=genotype)
        return {"path": path, "space": space, "genotype": genotype}

    def fit(self, epochs: Optional[int] = None) -> dict:
        """Epochs from ``start_epoch``; validates every ``eval_interval``
        epochs and after the last. Returns the last validation's result
        with ``train_loss`` and that epoch's ``step_ms`` and
        ``step_losses`` (its weight steps' losses)."""
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
                result["step_losses"] = self.step_losses
        return result
