"""Experiment checkpointing (utils/saver.py of the JAX package; the
reference's utils/saver.py).

The JAX package's run-directory contract: ``run/{dataset}/{checkname}/
experiment_N`` numbered on, ``checkpoint`` beside ``checkpoint.meta.json``
(``epoch``, ``best_pred``), ``best_pred.txt`` and ``best_model`` promoted
when an experiment beats every earlier one's best, and the config in
``parameters.txt``. The port writes a checkpoint as one ``torch.save``
file (the model's state_dict, whose names are the flax paths, the
optimizer's state and the step). It reads both that and the JAX package's
orbax directories (``utils/orbax_reader.py``, without orbax): an orbax
checkpoint comes back as the JAX tree of numpy arrays (``params``,
``batch_stats`` and ``opt_state`` and ``step``, or the search's ``arch``,
``w_opt`` and ``a_opt``, or an EDM's ``params``), which
``bridge.load_checkpoint_weights``, ``TrainStep.load_state_dict`` and
``SearchSteps.load_state_dict`` take. A checkpoint of either kind counts
as committed once its ``.meta.json`` exists, which both packages write
after the checkpoint is in place.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..bridge import load_checkpoint_weights
from .orbax_reader import is_orbax_checkpoint, read_orbax_checkpoint


def _experiments(directory: str):
    runs = glob.glob(os.path.join(directory, "experiment_*"))
    return sorted(runs, key=lambda r: int(r.rsplit("_", 1)[-1]))


def find_latest_checkpoint(
    directory_root: str, dataset: str, checkname: str, filename: str = "checkpoint"
) -> Optional[str]:
    """The newest experiment's committed ``filename`` under
    run/{dataset}/{checkname}, a port file or an orbax directory of the JAX
    package, whichever wrote the newest: the auto-resume (preemption)
    discovery."""
    for run in reversed(_experiments(os.path.join(directory_root, dataset, checkname))):
        path = os.path.join(run, filename)
        if (os.path.isfile(path) or is_orbax_checkpoint(path)) and os.path.exists(path + ".meta.json"):
            return os.path.abspath(path)
    return None


def checkpoint_path(path: str, filename: str = "checkpoint") -> str:
    """``path`` when it is a checkpoint (a port file or an orbax
    directory), else the ``filename`` of the experiment directory ``path``."""
    if os.path.isfile(path) or is_orbax_checkpoint(path) or not os.path.isdir(path):
        return path
    return os.path.join(path, filename)


def restore_checkpoint(path: str, map_location="cpu") -> Tuple[Any, Dict]:
    """(state, meta) of a checkpoint: a file written by ``Saver``, or an
    orbax directory written by the JAX package's, whose state is the JAX
    tree of numpy arrays (see the module doc)."""
    if is_orbax_checkpoint(path):
        state = read_orbax_checkpoint(path)
    else:
        state = torch.load(path, map_location=map_location, weights_only=True)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state, meta


def _save(state: Any, path: str):
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


class Saver:
    def __init__(self, directory_root: str, dataset: str, checkname: str):
        self.directory = os.path.join(directory_root, dataset, checkname)
        self.runs = _experiments(self.directory)
        run_id = max((int(r.rsplit("_", 1)[-1]) for r in self.runs), default=-1) + 1
        self.experiment_dir = os.path.join(self.directory, f"experiment_{run_id}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_checkpoint(
        self, state: Any, is_best: bool, epoch: int, best_pred: float, filename: str = "checkpoint"
    ):
        """Persist ``state`` and {epoch, best_pred}; when ``is_best``, write
        best_pred.txt and promote to best_model if no earlier experiment's
        best_pred.txt is higher (saver.py:22-45)."""
        path = os.path.join(self.experiment_dir, filename)
        _save(state, path)
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, "best_pred": best_pred}, f)
        if not is_best:
            return
        with open(os.path.join(self.experiment_dir, "best_pred.txt"), "w") as f:
            f.write(str(best_pred))
        previous = [0.0]
        for run in self.runs:
            p = os.path.join(run, "best_pred.txt")
            if os.path.exists(p):
                with open(p) as f:
                    previous.append(float(f.read()))
        if best_pred > max(previous):
            _save(state, os.path.join(self.experiment_dir, "best_model"))

    def load_checkpoint(self, target=None, filename: str = "checkpoint", map_location="cpu"):
        """(state, meta) of this experiment's ``filename``; when ``target``
        is a module, its weights are loaded from the state (the JAX package
        restores into a pytree of the target's structure)."""
        state, meta = restore_checkpoint(os.path.join(self.experiment_dir, filename), map_location)
        if target is not None:
            load_checkpoint_weights(target, state)
        return state, meta

    def save_architecture(
        self,
        epoch: int,
        network_path: np.ndarray,
        betas: Optional[np.ndarray] = None,
        genotype: Optional[np.ndarray] = None,
    ) -> str:
        """The decoded architecture of a search epoch (search.py:296-327):
        ``arch_epoch_{epoch}/`` with network_path.npy, betas.npy and, for a
        cell search, genotype.npy."""
        d = os.path.join(self.experiment_dir, f"arch_epoch_{epoch}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "network_path.npy"), np.asarray(network_path))
        if betas is not None:
            np.save(os.path.join(d, "betas.npy"), np.asarray(betas))
        if genotype is not None:
            np.save(os.path.join(d, "genotype.npy"), np.asarray(genotype))
        return d

    def save_experiment_config(self, config: Dict[str, Any]):
        with open(os.path.join(self.experiment_dir, "parameters.txt"), "w") as f:
            for k, v in sorted(config.items()):
                f.write(f"{k}: {v}\n")
