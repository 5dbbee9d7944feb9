"""FLOP of the reference's segments, counted by ``torch.utils.flop_counter``
over the plain reference on the meta device at a cell's shape: what the
model needs, whatever the program runs (its packed or folded forms count
more or less). Convolutions and matmuls only, a multiply-add counting 2."""
from __future__ import annotations

import functools
import json
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.add import Arch, Reference, all_specs, segment_names, split_weights


def segment_flops(cfg: dict, image_hw) -> Dict[str, int]:
    """{segment: FLOP} for one image of ``image_hw`` = (H, W)."""
    return dict(_segment_flops(json.dumps(cfg, sort_keys=True), tuple(int(v) for v in image_hw)))


@functools.lru_cache(maxsize=8)
def _segment_flops(cfg_json: str, image_hw) -> tuple:
    cfg = json.loads(cfg_json)
    arch = Arch(cfg)
    flat = {n: torch.empty(s, device="meta") for n, s, _ in all_specs(arch)}
    ref = Reference(cfg, *split_weights(flat))
    x = torch.empty((1, *image_hw, 3), device="meta")
    out = {}
    with torch.no_grad():
        carry = x
        for k in range(len(arch.exits) - 1):
            with FlopCounterMode(display=False) as fc:
                carry, _ = ref.decide(k, carry)
            out[f"decide_{k}"] = fc.get_total_flops()
            with FlopCounterMode(display=False) as fc:
                ref.head(carry, arch.exits[k], image_hw)
            out[f"head_{k}"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            ref.final(carry, image_hw)
        out["final"] = fc.get_total_flops()
    if set(out) != set(segment_names(arch)):
        raise AssertionError(f"segments {sorted(out)} against {segment_names(arch)}")
    return tuple(sorted(out.items()))
