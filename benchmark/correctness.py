"""The comparison that decides ``correct``: what the timed path produced for
a seeded sample of the window's requests against the plain reference run
on the same image, weights and threshold, once the window has closed.

Numbers compared, each against its limit from the cell's file:
  * ``logits_rel_err``: over the sampled images, the largest
    max|logits - reference| / max|reference| (the logits of the exit each
    side took);
  * ``conf_rel_err``: over every decision both sides took, the largest
    |confidence - reference| over the largest |reference confidence|;
  * ``exit_mismatches``: sampled images whose exit differs from the
    reference's;
  * ``scheduled_exit_misses``: requests of the whole window whose exit
    differs from the one their threshold forces.

A limit of None reads and prints the number without comparing it.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

ORDER = ("logits_rel_err", "conf_rel_err", "exit_mismatches", "scheduled_exit_misses")


def compare(samples: List[dict], reference, pool, device, limits: Dict[str, float],
            scheduled_exit_misses: int) -> Dict[str, dict]:
    """{name: {"value", "limit"}} in ``ORDER``. Each sample: {"image",
    "threshold", "logits", "exit", "confs"} (``confs``: the confidences of
    the decisions the program took, in order; it may hold only the first)."""
    errs, conf_gaps, ref_confs, mismatches = [], [], [], 0
    for s in samples:
        x = pool[s["image"]:s["image"] + 1].to(device)
        ref_logits, ref_exit, confs = reference.infer(x, s["threshold"])
        got = s["logits"].to(device=ref_logits.device, dtype=torch.float32)
        errs.append(float((got - ref_logits).abs().max() / ref_logits.abs().max()))
        mismatches += int(s["exit"] != ref_exit)
        values = [float(c[0]) for c in confs]
        ref_confs += values
        conf_gaps += [abs(a - b) for a, b in zip(s["confs"], values)]
        del ref_logits, got
    scale = max((abs(v) for v in ref_confs), default=0.0)
    values = {"logits_rel_err": _worst(errs),
              "conf_rel_err": _worst(conf_gaps) / scale if scale > 0 else math.nan,
              "exit_mismatches": mismatches, "scheduled_exit_misses": scheduled_exit_misses}
    return {k: {"value": values[k], "limit": limits[k]} for k in ORDER}


def _worst(xs: List[float]) -> float:
    """The largest of ``xs``; NaN when it is empty or holds a NaN."""
    return math.nan if not xs or any(math.isnan(x) for x in xs) else max(xs)


def passed(checks: Dict[str, dict]) -> bool:
    """Every number within its limit; a NaN is never within one. A number
    whose limit is None is read and printed, and not compared: the cell's
    control does not separate it from sound runs (its file says why)."""
    return all(c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None)


def lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" if c["limit"] is not None
            else f"check {k} {c['value']!r} not compared" for k, c in checks.items()]
