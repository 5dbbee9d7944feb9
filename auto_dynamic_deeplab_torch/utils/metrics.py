"""Segmentation metrics (utils/metrics.py of the JAX package): a running
num_class² confusion matrix accumulated on the labels' device with
``torch.bincount``; mIoU and pixel accuracy are reduced on the host
with a nan-mean over absent classes (mIoU, pixel accuracy, per-class
accuracy, frequency-weighted IoU). Only the small matrix is fetched."""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_update(gt: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts for one batch; pixels whose
    gt is outside [0, num_classes) (e.g. ignore=255) are dropped."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    idx = gt[valid] * num_classes + pred[valid]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def _nanmean(x: np.ndarray) -> float:
    return float(np.nanmean(x)) if np.any(~np.isnan(x)) else float("nan")


class Evaluator:
    """Running confusion-matrix evaluator (API parity with utils/metrics.py)."""

    def __init__(self, num_class: int, device="cpu"):
        self.num_class = num_class
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self.confusion_matrix = torch.zeros(
            (self.num_class, self.num_class), dtype=torch.int64, device=self.device
        )

    def add_batch(self, gt_image, pre_image):
        gt = torch.as_tensor(gt_image, device=self.device)
        pred = torch.as_tensor(pre_image, device=self.device)
        if gt.shape != pred.shape:
            raise ValueError(f"label shape {tuple(gt.shape)} != prediction {tuple(pred.shape)}")
        self.confusion_matrix += confusion_matrix_update(gt, pred, self.num_class)

    def _cm(self) -> np.ndarray:
        return self.confusion_matrix.cpu().numpy().astype(np.float64)

    def Pixel_Accuracy(self) -> float:
        cm = self._cm()
        return float(np.diag(cm).sum() / cm.sum())

    def Pixel_Accuracy_Class(self) -> float:
        cm = self._cm()
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return _nanmean(acc)

    def Mean_Intersection_over_Union(self) -> float:
        cm = self._cm()
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return _nanmean(iou)

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self._cm()
        freq = cm.sum(axis=1) / cm.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float((freq[freq > 0] * iou[freq > 0]).sum())
