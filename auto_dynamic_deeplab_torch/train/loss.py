"""Segmentation losses (train/loss.py of the JAX package): parity with
torch.nn.CrossEntropyLoss(weight, ignore_index=255) as the reference's
drivers build it (train.py:70, utils/loss.py), on (N, C, H, W) logits.

  * per-pixel NLL of log_softmax(logits) at the target class, in fp32;
  * pixels whose target is ``ignore_index`` or outside [0, C) contribute 0
    (``F.cross_entropy`` raises or device-asserts on the latter, so the
    mask is taken here);
  * the mean divides by the summed class weights of the valid pixels (the
    pixel count without weights), floored at 1e-12: an all-ignored batch
    gives 0.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def cross_entropy_terms(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean's numerator (the summed weighted NLL) and denominator (the
    summed weights of the valid pixels), fp32 scalars: a batch split over
    ranks has the global mean Σ numerators / Σ denominators."""
    num_classes = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    t = target.long()
    valid = (t >= 0) & (t < num_classes) & (t != ignore_index)
    t_safe = torch.where(valid, t, 0)
    nll = -logp.gather(1, t_safe[:, None])[:, 0]
    if weight is None:
        w = valid.float()
    else:
        w = torch.where(valid, weight.to(logits.device, torch.float32)[t_safe], 0.0)
    return (nll * w).sum(), w.sum()


def cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = 255,
) -> torch.Tensor:
    """logits (N, C, H, W), target (N, H, W) int → scalar fp32 loss."""
    num, den = cross_entropy_terms(logits, target, weight, ignore_index)
    return num / den.clamp_min(1e-12)


def multi_exit_cross_entropy(
    logits_list: Sequence[torch.Tensor],
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = 255,
    reduce: str = "mean",
) -> torch.Tensor:
    """Joint loss over exits: ``'mean'`` is the per-exit mean
    (train.py:229-233, search.py:190-194), ``'sum'`` the plain sum of the
    2-exit search_layer driver (search_layer.py:187-196)."""
    if reduce not in ("mean", "sum"):
        raise NotImplementedError(reduce)
    total = sum(cross_entropy(lg, target, weight, ignore_index) for lg in logits_list)
    return total / len(logits_list) if reduce == "mean" else total


class SegmentationLosses:
    """API parity with the reference's loss factory (utils/loss.py:4-25):
    ``SegmentationLosses(weight, ignore_index).build_loss("ce")`` is a
    callable ``(logits (N, C, H, W), target (N, H, W)) -> scalar`` with
    ``cross_entropy``'s semantics; other modes raise."""

    def __init__(self, weight=None, ignore_index: int = 255):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.ignore_index = ignore_index

    def build_loss(self, mode: str = "ce") -> "SegmentationLosses":
        if mode != "ce":
            raise NotImplementedError(mode)
        return self

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return cross_entropy(logits, target, self.weight, self.ignore_index)
